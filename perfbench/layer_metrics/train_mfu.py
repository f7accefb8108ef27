"""train_mfu (%): the step's model FLOPs (``counts.granite.step_flops``) over
the traced window's mean step time, as a share of the card's published bf16
peak.  Read beside the card's power limit (the result line's ``device``)."""

from perfbench.counts import granite, peaks


def read(rec):
    if not rec.get("steps"):
        return None
    cfg = rec["model"]
    flops = granite.step_flops(cfg, cfg["global_batch"], cfg["seq_len"])
    return 100.0 * flops / rec["step_s"] / peaks.BF16_FLOPS
