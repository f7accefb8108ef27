"""train.span.moe_ms (ms): the device ms a step of the program's span ``moe``
(each MoE layer's routing, dispatch, held experts, combine and shared
experts: its forward, its remat recompute and its backward), the mean over
the traced run's device-timed steps (``rec["program_spans"]``)."""

from perfbench.harness.program_stretch import span_ms


def read(rec):
    return span_ms(rec, "moe")
