"""Carry SVD states between the reference package and the port, as numpy arrays.

``state_from_arrays`` builds the port's ``SvdState`` from the leaves of a
reference ``SvdState`` (given as numpy arrays); ``state_to_arrays`` returns
the port's leaves as numpy arrays (16-bit leaves come back as float32, which
numpy can hold).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.policy import as_torch_dtype
from repro_torch.api.state import SvdState, resolve_device

__all__ = ["state_from_arrays", "state_to_arrays"]

_FIELDS = ("u", "s", "v", "d_left", "d_right")


def state_from_arrays(u, s, v, d_left=None, d_right=None, *, device, dtype=None) -> SvdState:
    """A port ``SvdState`` on ``device`` from numpy factors."""
    dev = resolve_device(device)
    dt = None if dtype is None else as_torch_dtype(dtype)

    def conv(x):
        if x is None:
            return None
        x = torch.as_tensor(np.asarray(x), device=dev)
        return x if dt is None else x.to(dt)

    st = SvdState.from_factors(u, s, v, device=dev, dtype=dt)
    return st.replace(d_left=conv(d_left), d_right=conv(d_right))


def state_to_arrays(state: SvdState) -> dict[str, np.ndarray]:
    """The state's leaves as numpy arrays; absent diagnostics are left out."""
    out = {}
    for f in _FIELDS:
        x = getattr(state, f)
        if x is not None:
            x = x.detach().cpu()
            out[f] = (x.float() if x.dtype.itemsize <= 2 else x).numpy()
    return out
