"""train.optimizer_rest_ms (ms): CUDA events around
``optim.spectral_adam.spectral_adam_update`` less those around the trackers'
update inside it, the mean over the traced window's steps (the basis
refresh, every few steps, stays in it)."""


def read(rec):
    steps = rec.get("pieces")
    if not steps:
        return None
    return sum(s["optimizer"] - s["trackers"] for s in steps) / len(steps)
