"""train.trackers_syncs (count): runtime calls a step in which the host blocked on the
card (``harness.program_trace.SYNC_CALLS``) inside the program's span
``trackers``, in the program stretch's profiled steps."""

from perfbench.harness.program_stretch import traced


def read(rec):
    return traced(rec, "trackers", "syncs")
