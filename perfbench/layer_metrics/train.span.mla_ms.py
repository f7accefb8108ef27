"""train.span.mla_ms (ms): the device ms a step of the program's span ``mla``
(``obs.blocks.traced_block`` around each layer's latent attention: its
forward, its remat recompute and its backward), the mean over the traced
run's device-timed steps (``rec["program_spans"]``)."""

from perfbench.harness.program_stretch import span_ms


def read(rec):
    return span_ms(rec, "mla")
