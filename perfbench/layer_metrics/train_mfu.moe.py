"""train_mfu.moe (%): a DeepSeek-V2 training step's model FLOPs
(``counts.deepseek_v2.step_flops``: MLA unabsorbed over the full (s, s)
square, the held experts at their expected share of the choices, the shared
experts, the dense layer and the head over the vocabulary slice) over the
window's mean step time, as a share of the card's published bf16 peak.
Read beside the card's power limit (the result line's ``device``)."""

from perfbench.counts import deepseek_v2, peaks


def read(rec):
    if not rec.get("steps") or rec["model"].get("model_type") != "deepseek_v2":
        return None
    cfg = rec["model"]
    flops = deepseek_v2.step_flops(cfg, cfg["global_batch"], cfg["seq_len"])
    return 100.0 * flops / rec["step_s"] / peaks.BF16_FLOPS
