"""train.span.optimizer_rest_ms (ms): the device ms of the program's span
``optimizer`` less its span ``trackers`` (the basis refresh, every few
steps, stays in it), the mean over the program stretch's steps
(``harness.program_stretch``)."""

from perfbench.harness.program_stretch import span_ms


def read(rec):
    return span_ms(rec, "optimizer", less="trackers")
