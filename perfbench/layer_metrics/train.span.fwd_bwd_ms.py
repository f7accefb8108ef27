"""train.span.fwd_bwd_ms (ms): the device ms of the program's span ``fwd_bwd``
(``train.loop.train_step``'s forward and backward), the mean over the
program stretch's steps (``harness.program_stretch``)."""

from perfbench.harness.program_stretch import span_ms


def read(rec):
    return span_ms(rec, "fwd_bwd")
