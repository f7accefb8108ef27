"""train.fwd_bwd_ms (ms): CUDA events around ``train.loop.loss_and_grads``
(the models' forward and backward), the mean over the traced window's steps."""


def read(rec):
    steps = rec.get("pieces")
    return sum(s["fwd_bwd"] for s in steps) / len(steps) if steps else None
