"""train.trackers_launches (count): device operations (kernels, copies, sets) a step
whose launching runtime call began inside the program's span ``trackers``,
in the program stretch's profiled steps (``harness.program_trace``)."""

from perfbench.harness.program_stretch import traced


def read(rec):
    return traced(rec, "trackers", "launches")
