"""Carry SVD states between the reference package and the port, as numpy arrays.

``state_from_arrays`` builds the port's ``SvdState`` from the leaves of a
reference ``SvdState`` (given as numpy arrays); ``state_to_arrays`` returns
the port's leaves as numpy arrays (16-bit leaves come back as float32, which
numpy can hold).  The snapshot converters carry a service's or a fleet's
snapshot between the packages as its leaves (numpy, in the reference's
pytree order) and its aux spec.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.policy import as_torch_dtype
from repro_torch.api.state import SvdState, resolve_device

__all__ = ["fleet_snapshot_from_reference", "fleet_snapshot_to_reference",
           "snapshot_from_reference", "snapshot_to_reference", "state_from_arrays",
           "state_to_arrays"]

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


def snapshot_from_reference(leaves, aux: dict):
    """The port's ``ServiceSnapshot`` of a reference snapshot's leaves (numpy,
    in its pytree order) and aux spec; restore it with
    ``SvdService.from_snapshot(snap, device=...)``."""
    from repro_torch.serve.svd_service import ServiceSnapshot

    return ServiceSnapshot.from_leaves([np.asarray(x) for x in leaves], aux)


def snapshot_to_reference(snap) -> tuple[list, dict]:
    """``(leaves, aux)`` of a port ``ServiceSnapshot``: the leaves as numpy
    arrays in the reference's pytree order (tensors copied to the host, dtype
    kept) and the aux spec."""
    from repro_torch.train.checkpoint import _to_numpy

    return [_to_numpy(x) for x in snap.leaves()], snap.aux()


def fleet_snapshot_from_reference(leaves, aux: dict):
    """The port's ``FleetSnapshot`` of a reference fleet snapshot's leaves
    (numpy, in its pytree order) and aux spec; restore it with
    ``SvdFleet.from_snapshot(snap, device=...)``."""
    from repro_torch.fleet import FleetSnapshot

    return FleetSnapshot.from_leaves([np.asarray(x) for x in leaves], aux)


def fleet_snapshot_to_reference(snap) -> tuple[list, dict]:
    """``(leaves, aux)`` of a port ``FleetSnapshot``, as
    ``snapshot_to_reference`` gives them for a service."""
    return snapshot_to_reference(snap)
