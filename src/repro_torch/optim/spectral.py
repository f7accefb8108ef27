"""Spectral gradient projection — the paper's technique as an optimizer
feature, in PyTorch.

Counterpart of ``repro.optim.spectral``.  GaLore-style low-rank
optimizer-state compression, where each 2-D parameter keeps a *streaming*
truncated SVD of its gradient history (an ``api.SvdState`` tracker) that is
updated every step with the paper's rank-1 machinery through ``api.update``
(the Brand-augmented truncated route; ``method="direct"`` by default, as in
the reference: the phase chain).

Per step and per (m, n) parameter:
  1. one warm-started power-iteration step extracts the dominant rank-1
     component of the fresh gradient: g ≈ sigma * u v^T           O(m n)
  2. the tracker SVD is updated with that rank-1 term
  3. the gradient is projected onto the rank-r left basis: G_p = U_r^T G,
     and Adam moments live in the (r, n) projected space.

``SpectralState.step`` is a 0-dim int32 tensor on the CPU (a host-side
count).  ``spectral_init`` builds the state on ``device`` (the card by
default) from a ``torch.Generator`` that draws there; carry the reference's
draws over with
``convert.spectral_state_from_reference``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.api import SvdState, UpdatePolicy, as_state, update as api_update
from repro_torch.api.policy import policy_from_legacy
from repro_torch.api.state import generator_device
from repro_torch.core.engine import group_indices, stack_trees, unstack_tree
from repro_torch.obs.trace import span

__all__ = [
    "SpectralState",
    "spectral_init",
    "spectral_update_basis",
    "spectral_update_basis_grouped",
    "project",
    "unproject",
]


class SpectralState(NamedTuple):
    tracker: SvdState         # streaming SVD of the gradient history
    power_v: torch.Tensor     # (n,) warm-started power-iteration vector
    step: torch.Tensor        # 0-dim int32, on the CPU


def spectral_init(gen: torch.Generator, m: int, n: int, rank: int, dtype=torch.float32, *,
                  device="cuda") -> SpectralState:
    """Random orthonormal bases and a random power vector on ``device``."""
    dev = generator_device(gen, device)
    u0, _ = torch.linalg.qr(torch.randn((m, rank), generator=gen, device=dev, dtype=dtype))
    v0, _ = torch.linalg.qr(torch.randn((n, rank), generator=gen, device=dev, dtype=dtype))
    return SpectralState(
        tracker=SvdState(u=u0, s=torch.zeros((rank,), dtype=dtype, device=dev), v=v0),
        power_v=torch.randn((n,), generator=gen, device=dev, dtype=dtype) / (n ** 0.5),
        step=torch.zeros((), dtype=torch.int32),
    )


def _rank1_of_grad(state: SpectralState, grad: torch.Tensor, decay: float):
    """Power-iteration front half: decayed tracker + (a, b) rank-1 vectors.

    Works on a single state or on stacked ones (leading batch axis), so the
    grouped path hands the stacked (a, b) pairs to one engine call."""
    g = grad.to(state.tracker.u.dtype)

    # one warm-started power iteration: v <- G^T G v / |.|, u = G v / |G v|
    v = state.power_v
    gv = (g @ v[..., None])[..., 0]
    u = gv / (torch.linalg.vector_norm(gv, dim=-1, keepdim=True) + 1e-30)
    gtu = (g.mT @ u[..., None])[..., 0]
    sigma = torch.linalg.vector_norm(gtu, dim=-1, keepdim=True)
    v_new = gtu / (sigma + 1e-30)

    # decay the tracker (recency weighting) before the rank-1 absorption
    tr = state.tracker.replace(s=state.tracker.s * decay)
    root = torch.sqrt(sigma)
    return tr, u * root, v_new * root, v_new


def spectral_update_basis(state: SpectralState, grad: torch.Tensor, *, decay: float = 0.99,
                          method: str = "direct",
                          policy: UpdatePolicy | None = None) -> SpectralState:
    """Fold the fresh gradient's dominant rank-1 component into the tracker."""
    pol = policy_from_legacy(policy, method)
    tr, a_vec, b_vec, v_new = _rank1_of_grad(state, grad, decay)
    tr = api_update(tr, a_vec, b_vec, pol)
    return SpectralState(tracker=tr, power_v=v_new, step=state.step + 1)


def spectral_update_basis_grouped(
    states: Sequence[SpectralState],
    grads: Sequence[torch.Tensor],
    *,
    decay: float = 0.99,
    method: str = "direct",
    policy: UpdatePolicy | None = None,
    mesh=None,
    batch_axis: str = "data",
) -> tuple[SpectralState, ...]:
    """Batched basis update: parameters sharing (m, n, rank, dtype) are
    stacked and their trackers updated by one batched ``api.update`` — B
    rank-1 updates for one plan.  ``policy.mesh`` (or the legacy ``mesh=``)
    spreads each group's batch over the mesh's batch axis.  Spans (``obs``):
    ``tracker_group`` (args m, n, rank, batch) around each group, and
    ``power_iter`` around its rank-1 estimate of the gradients."""
    if len(states) != len(grads):
        raise ValueError("states and grads must pair up")
    pol = policy_from_legacy(policy, method, mesh=mesh, batch_axis=batch_axis)

    keys = []
    for i, (st, g) in enumerate(zip(states, grads)):
        tr = as_state(st.tracker)
        if tuple(g.shape) != (tr.m, tr.n):
            raise ValueError(f"grad {i} shape {tuple(g.shape)} != tracker geometry "
                             f"{(tr.m, tr.n)}")
        keys.append((tr.m, tr.n, tr.rank, tr.dtype))

    out: list[SpectralState | None] = [None] * len(states)
    for idxs in group_indices(keys).values():
        m, n, rank, _ = keys[idxs[0]]
        with span("tracker_group", m=m, n=n, rank=rank, batch=len(idxs)):
            stacked = SpectralState(
                tracker=stack_trees([as_state(states[i].tracker) for i in idxs]),
                power_v=torch.stack([states[i].power_v for i in idxs]),
                step=torch.stack([states[i].step for i in idxs]))
            g_stack = torch.stack([grads[i] for i in idxs])
            with span("power_iter"):
                tr, a_vec, b_vec, v_new = _rank1_of_grad(stacked, g_stack, decay)
            tr = api_update(tr, a_vec, b_vec, pol)
            for j, i in enumerate(idxs):
                out[i] = SpectralState(tracker=unstack_tree(tr, j), power_v=v_new[j],
                                       step=stacked.step[j] + 1)
    return tuple(out)


def project(state: SpectralState, grad: torch.Tensor) -> torch.Tensor:
    """G_p = U_r^T G  — (r, n) projected gradient."""
    return state.tracker.u.mT @ grad.to(state.tracker.u.dtype)


def unproject(state: SpectralState, update_p: torch.Tensor) -> torch.Tensor:
    """Back to parameter space: U_r @ update_p."""
    return state.tracker.u @ update_p
