"""Carry states between the reference package and the port, as numpy arrays.

``state_from_arrays`` builds the port's ``SvdState`` from the leaves of a
reference ``SvdState`` (given as numpy arrays); ``state_to_arrays`` returns
the port's leaves as numpy arrays (16-bit leaves come back as float32, which
numpy can hold).  The snapshot converters carry a service's or a fleet's
snapshot between the packages as its leaves (numpy, in the reference's
pytree order) and its aux spec.

The training states go the same way: ``params_from_reference``,
``adamw_state_from_reference``, ``spectral_state_from_reference``,
``spectral_adam_state_from_reference`` and
``compression_state_from_reference`` take the reference's trees with numpy
(or any array) leaves, for instance ``jax.tree.map(np.asarray, state)``, and
build the port's on ``device`` (a step counter stays on the CPU, where the
port keeps it).  ``tree_to_arrays`` is the way back: the port's tree with
numpy leaves, in the port's classes; its leaves, in
``_tree.tree_leaves`` order, are the reference's in
``jax.tree.leaves`` order, so ``jax.tree.unflatten(treedef_of_the_reference,
tree_leaves(tree_to_arrays(x)))`` rebuilds the reference's tree.

Serving caches go the same way: ``cache_from_reference`` takes any cache of
the decoder or the hybrid (the fp KV cache, the int8 one with its float32
scales, the MLA cache, the hybrid state with ``groups`` / ``attn_kv`` /
``tail``), RWKV's stacked state (``tm_x`` / ``wkv`` / ``cm_x``: the token
shifts bfloat16 from the decode specs or float32 after a step, wkv float32)
or the encoder-decoder's cache (``self`` / ``cross``, each ``k`` / ``v``;
the cross K/V in the frames' dtype) with numpy leaves and builds the port's
on ``device``, dtypes kept; ``cache_to_arrays`` is the way back, a bfloat16
leaf as float32 (exact).  The parameters of every family (the stacked
``layers``, ``enc_layers`` / ``dec_layers``) go through
``params_from_reference`` and ``tree_to_arrays``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.policy import as_torch_dtype
from repro_torch.api.state import SvdState, resolve_device

__all__ = ["adamw_state_from_reference", "cache_from_reference", "cache_to_arrays",
           "compression_state_from_reference",
           "fleet_snapshot_from_reference", "fleet_snapshot_to_reference",
           "params_from_reference", "snapshot_from_reference", "snapshot_to_reference",
           "spectral_adam_state_from_reference", "spectral_state_from_reference",
           "state_from_arrays", "state_to_arrays", "tree_to_arrays"]

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


# -- training states ---------------------------------------------------------


def _step(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.int32))


def params_from_reference(params, *, device) -> dict:
    """The port's parameter tree (nested dicts of tensors on ``device``) from
    the reference's (nested dicts of arrays), leaf for leaf, dtypes kept (a
    bfloat16 leaf, as numpy holds it through ``ml_dtypes``, included)."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: params_from_reference(v, device=dev) for k, v in params.items()}
    a = np.asarray(params)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=dev)


def adamw_state_from_reference(st, *, device):
    """The port's ``AdamWState`` from the reference's (``step``, ``m``, ``v``)."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(step=_step(st.step), m=params_from_reference(st.m, device=device),
                      v=params_from_reference(st.v, device=device))


def _tracker(tr, device) -> SvdState:
    return state_from_arrays(np.array(tr.u), np.array(tr.s), np.array(tr.v),
                             getattr(tr, "d_left", None), getattr(tr, "d_right", None),
                             device=device)


def spectral_state_from_reference(sp, *, device):
    """The port's ``SpectralState`` (tracker, power vector, step)."""
    from repro_torch.optim.spectral import SpectralState

    dev = resolve_device(device)
    return SpectralState(tracker=_tracker(sp.tracker, dev),
                         power_v=torch.as_tensor(np.array(sp.power_v), device=dev),
                         step=_step(sp.step))


def _leaf_state(node, dev):
    from repro_torch.optim.spectral_adam import _LeafState

    if isinstance(node, dict):
        return {k: _leaf_state(v, dev) for k, v in node.items()}
    (ls,) = node
    spec = None if ls.spectral is None else spectral_state_from_reference(ls.spectral, device=dev)
    return (_LeafState(spectral=spec, m=torch.as_tensor(np.array(ls.m), device=dev),
                       v=torch.as_tensor(np.array(ls.v), device=dev)),)


def spectral_adam_state_from_reference(st, *, device):
    """The port's ``SpectralAdamState``: the leaves' tree of ``(_LeafState,)``
    with each tracker carried over."""
    from repro_torch.optim.spectral_adam import SpectralAdamState

    return SpectralAdamState(step=_step(st.step),
                             leaves=_leaf_state(st.leaves, resolve_device(device)))


def compression_state_from_reference(cs, *, device):
    """The port's ``CompressionState`` (basis, error buffer, tracker)."""
    from repro_torch.optim.compression import CompressionState

    dev = resolve_device(device)
    return CompressionState(v_basis=torch.as_tensor(np.array(cs.v_basis), device=dev),
                            error=torch.as_tensor(np.array(cs.error), device=dev),
                            tracker=_tracker(cs.tracker, dev))


def tree_to_arrays(tree):
    """``tree`` (any of the port's states or parameter trees) with every
    tensor leaf copied to the host as a numpy array, structure kept."""
    from repro_torch._tree import tree_leaves, tree_unflatten
    from repro_torch.train.checkpoint import _to_numpy

    return tree_unflatten(tree, [_to_numpy(x) for x in tree_leaves(tree)])


# -- serving caches ----------------------------------------------------------


def cache_from_reference(cache, *, device) -> dict:
    """The port's decode cache or hybrid state from the reference's (nested
    dicts of arrays), leaf for leaf as ``params_from_reference`` carries
    them, dtypes kept (int8 entries, float32 scales and SSM states, bfloat16
    or float32 KV)."""
    return params_from_reference(cache, device=device)


def cache_to_arrays(cache) -> dict:
    """A port cache as nested dicts of numpy arrays, dtypes kept but
    bfloat16, which comes back as float32 (exact)."""
    if isinstance(cache, dict):
        return {k: cache_to_arrays(v) for k, v in cache.items()}
    x = cache.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
