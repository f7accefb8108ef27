"""Spectral AdamW: AdamW with streaming-SVD low-rank moment projection, in
PyTorch.

Counterpart of ``repro.optim.spectral_adam``, with the same state layout
(``SpectralAdamState(step, leaves)``, ``leaves`` the parameters' tree with a
1-tuple ``(_LeafState,)`` at each leaf), so checkpoints carry over.  Every
2-D parameter with min(m, n) > 4*rank keeps

  * a ``SpectralState`` (streaming truncated SVD of its gradient history,
    kept by the api's truncated rank-1 route), and
  * Adam moments in the (rank, n) projected space instead of (m, n).

Per step and per projected parameter:
  1. fold the fresh gradient's dominant rank-1 into the tracker
     (``update_basis_every`` sets the cadence; one batched ``api.update`` a
     geometry group),
  2. G_p = U_r^T G; the Adam moment update in projected space;
  3. delta = U_r @ adam(G_p) back in parameter space (+ weight decay).
Other parameters (norms, biases, the decoder's stacked 3-D layer weights,
small matrices) fall through to dense AdamW.  There is no gradient
clipping on this path, as in the reference.

Spans (``obs``): ``trackers`` around step 1 (all groups), ``refresh`` around
the basis refresh, ``moments`` around steps 2-3 and dense AdamW.

Basis refresh (``basis_refresh_every``): every N steps each tracker passes
through ``compression.agree_tracker``; with a process group (``axis_name``)
that merges the per-worker trackers into one consensus, without one it is a
local re-factorisation that restores the orthonormal bases long streams
erode.

The reference branches on a device step with ``lax.cond``.  Here ``step``
is a 0-dim int32 tensor on the CPU that travels with the state, so both
cadences are decided on the host without waiting for the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._tree import flatten_up_to, tree_leaves, tree_unflatten
from repro_torch.api.state import generator_device
from repro_torch.core.engine import group_indices, stack_trees, unstack_tree
from repro_torch.obs.trace import span
from repro_torch.optim.adamw import bias_corrections
from repro_torch.optim.compression import agree_tracker
from repro_torch.optim.spectral import (
    SpectralState,
    project,
    spectral_init,
    spectral_update_basis_grouped,
    unproject,
)

__all__ = ["SpectralAdamState", "moment_memory_ratio", "spectral_adam_init",
           "spectral_adam_update"]


class _LeafState(NamedTuple):
    spectral: SpectralState | None
    m: torch.Tensor
    v: torch.Tensor


class SpectralAdamState(NamedTuple):
    step: torch.Tensor  # 0-dim int32, on the CPU
    leaves: object      # the parameters' tree of (_LeafState,) 1-tuples


def _eligible(p, rank):
    return p.dim() == 2 and min(p.shape) > 4 * rank


def spectral_adam_init(gen: torch.Generator, params, *, rank: int = 32,
                       device="cuda") -> SpectralAdamState:
    """The state on ``device`` (the card by default), where the parameters
    lie; the trackers are drawn from ``gen``, which draws there."""
    dev = generator_device(gen, device)
    leaves = []
    for p in tree_leaves(params):
        if p.device.type != dev.type:
            raise ValueError(f"a parameter lies on {p.device} but device={device!r}")
        if _eligible(p, rank):
            m, n = p.shape
            leaves.append(_LeafState(
                spectral=spectral_init(gen, m, n, rank, device=dev),
                m=torch.zeros((rank, n), dtype=torch.float32, device=p.device),
                v=torch.zeros((rank, n), dtype=torch.float32, device=p.device),
            ))
        else:
            leaves.append(_LeafState(spectral=None,
                                     m=torch.zeros_like(p, dtype=torch.float32),
                                     v=torch.zeros_like(p, dtype=torch.float32)))
    return SpectralAdamState(step=torch.zeros((), dtype=torch.int32),
                             leaves=tree_unflatten(params, [(l,) for l in leaves]))


def _refresh(specs, axis_name):
    """Every tracker through ``agree_tracker``: per leaf under a group (the
    collectives do not batch), else one batched re-factorisation a geometry."""
    if axis_name is not None:
        return [SpectralState(tracker=agree_tracker(s.tracker, axis_name=axis_name)[0],
                              power_v=s.power_v, step=s.step) for s in specs]
    out = list(specs)
    geos = [(tuple(s.tracker.u.shape), tuple(s.tracker.v.shape)) for s in specs]
    for idxs in group_indices(geos).values():
        refreshed = agree_tracker(stack_trees([specs[i].tracker for i in idxs]),
                                  axis_name=None)[0]
        for j, i in enumerate(idxs):
            out[i] = SpectralState(tracker=unstack_tree(refreshed, j), power_v=out[i].power_v,
                                   step=out[i].step)
    return out


def _moments(m, v, g, b1, b2, inplace):
    """``(b1 m + (1 - b1) g, b2 v + (1 - b2) g g)``; with ``inplace`` written
    into ``m`` and ``v`` by the same operations in the same order (the same
    bits)."""
    if not inplace:
        return b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_(((1 - b2) * g).mul_(g))
    return m, v


def _adam_direction(m, v, bc1, bc2, eps, inplace):
    """``(m / bc1) / (sqrt(v / bc2) + eps)``, with one temporary fewer in place."""
    if not inplace:
        return (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return (m / bc1).div_((v / bc2).sqrt_().add_(eps))


def _decayed(p, pf, delta, lr, weight_decay, inplace):
    """``pf - lr (delta + weight_decay pf)`` in ``p``'s dtype; with
    ``inplace`` written into ``p`` (``delta`` is consumed)."""
    if not inplace:
        return (pf - lr * (delta + weight_decay * pf)).to(p.dtype)
    delta.add_(weight_decay * pf).mul_(lr)
    return p.sub_(delta) if pf is p else p.copy_(pf.sub_(delta))


def spectral_adam_update(grads, state: SpectralAdamState, params, *, lr, betas=(0.9, 0.95),
                         eps=1e-8, weight_decay=0.1, update_basis_every: int = 1,
                         basis_refresh_every: int = 0, axis_name=None, donate: bool = False):
    """One step: ``(new_params, new_state)``.  ``donate``: ``params`` and the
    moments of ``state`` are updated in place and returned (the reference's
    jitted step donates them), the same values with one copy of each live
    instead of two."""
    b1, b2 = betas
    step = state.step + 1
    host_step = int(step)  # a CPU tensor: no wait for the card
    bc1, bc2 = bias_corrections(step, betas)

    flat_g, flat_p = tree_leaves(grads), tree_leaves(params)
    flat_s = [t[0] for t in flatten_up_to(grads, state.leaves)]

    elig = [i for i, s in enumerate(flat_s) if s.spectral is not None]
    new_specs: dict[int, SpectralState] = {}
    if elig:
        updated = [flat_s[i].spectral for i in elig]
        if host_step % update_basis_every == 0:
            with span("trackers"):
                updated = list(spectral_update_basis_grouped(
                    updated, [flat_g[i].float() for i in elig]))
        if basis_refresh_every and host_step % basis_refresh_every == 0:
            with span("refresh"):
                updated = _refresh(updated, axis_name)
        new_specs = dict(zip(elig, updated))

    new_p, new_s = [], []
    with span("moments"):
        for i, (g, p, s) in enumerate(zip(flat_g, flat_p, flat_s)):
            gf = g.float()
            pf = p.float()
            if s.spectral is not None:
                spec = new_specs[i]
                gp = project(spec, gf)                          # (r, n)
                m2, v2 = _moments(s.m, s.v, gp, b1, b2, donate)
                upd_p = _adam_direction(m2, v2, bc1, bc2, eps, donate)
                delta = unproject(spec, upd_p)                  # (m, n)
                new_s.append(_LeafState(spectral=spec, m=m2, v=v2))
            else:
                m2, v2 = _moments(s.m, s.v, gf, b1, b2, donate)
                delta = _adam_direction(m2, v2, bc1, bc2, eps, donate)
                new_s.append(_LeafState(spectral=None, m=m2, v=v2))
            new_p.append(_decayed(p, pf, delta, lr, weight_decay, donate))

    return (tree_unflatten(grads, new_p),
            SpectralAdamState(step=step, leaves=tree_unflatten(grads, [(l,) for l in new_s])))


def moment_memory_ratio(params, rank: int) -> float:
    """Dense-Adam moment floats / spectral-Adam moment+tracker floats."""
    dense = proj = 0
    for p in tree_leaves(params):
        n_el = p.numel()
        dense += 2 * n_el
        if _eligible(p, rank):
            m, n = p.shape
            proj += 2 * rank * n + (m + n + 1) * rank + n
        else:
            proj += 2 * n_el
    return dense / max(proj, 1)
