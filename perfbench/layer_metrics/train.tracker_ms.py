"""train.tracker_ms (ms): CUDA events around
``optim.spectral_adam.spectral_update_basis_grouped`` (the trackers' rank-1
SVD updates through ``api.update``), the mean over the traced window's
steps."""


def read(rec):
    steps = rec.get("pieces")
    return sum(s["trackers"] for s in steps) / len(steps) if steps else None
