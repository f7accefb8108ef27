"""train.trackers_busy_ms (ms): device ms a step of the operations launched inside
the program's span ``trackers``, in the program stretch's profiled steps:
beside ``train.span.trackers_ms``, how far the host paces the trackers."""

from perfbench.harness.program_stretch import traced


def read(rec):
    s = traced(rec, "trackers", "device_s")
    return None if s is None else s * 1e3
