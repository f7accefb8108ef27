"""Low-rank gradient compression for the data-parallel all-reduce, in
PyTorch.

Counterpart of ``repro.optim.compression``.  PowerSGD-shaped compressed data
parallelism with the paper's streaming-SVD twist: each 2-D gradient is
compressed against a rank-r right basis V_r kept fresh by the rank-1 SVD
update (through ``api.update``), with error feedback so compression error
accumulates into the next step instead of being lost.

Per layer and step (every rank of the group calls, in the same order):
  1. G_fb = G + E                                 (error feedback)
  2. P = G_fb V_r           (m, r)                local projection
  3. P <- mean over the group                     ONLY P crosses the wire
  4. Q = G_fb^T P_hat       (n, r); Q <- mean     second factor (PowerSGD step)
  5. G_hat = P_hat Q^T;  E <- G_fb - G_hat        new error feedback
  6. the V_r tracker absorbs the rank-1 (u1, v1) of G_hat

Wire bytes per layer: r (m + n) * 4 instead of m n * 4 (``wire_bytes``).
The reference's ``axis_name`` is a ``torch.distributed`` process group here
(``dist.collectives``); ``None`` is the single worker.  Tracker containers
are preserved: a state built with a ``TruncatedSvd`` tracker keeps that type
through every update.  ``compression_init`` builds the state on ``device``
(the card by default) from a ``torch.Generator`` that draws there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as tdist

from repro_torch._tree import flatten_up_to, tree_leaves, tree_unflatten
from repro_torch.api import SvdState, UpdatePolicy, as_state, update as api_update
from repro_torch.api.policy import policy_from_legacy as _policy_for
from repro_torch.api.state import generator_device
from repro_torch.api.state import like_container as _like
from repro_torch.core.engine import (
    SvdEngine,
    group_indices,
    stack_trees,
    truncated_geometry,
    unstack_tree,
)
from repro_torch.dist import collectives
from repro_torch.dist import merge as dist_merge

__all__ = [
    "CompressionState",
    "agree_basis",
    "agree_tracker",
    "compression_init",
    "compress_decompress",
    "compress_decompress_batch",
    "compressed_allreduce",
    "refresh_basis",
    "wire_bytes",
]


class CompressionState(NamedTuple):
    v_basis: torch.Tensor   # (n, r) right basis (orthonormal-ish)
    error: torch.Tensor     # (m, n) error feedback buffer
    tracker: SvdState       # streaming SVD keeping the basis fresh


def compression_init(gen: torch.Generator, m: int, n: int, rank: int, dtype=torch.float32, *,
                     device="cuda") -> CompressionState:
    dev = generator_device(gen, device)
    v0, _ = torch.linalg.qr(torch.randn((n, rank), generator=gen, device=dev, dtype=dtype))
    u0, _ = torch.linalg.qr(torch.randn((m, rank), generator=gen, device=dev, dtype=dtype))
    return CompressionState(
        v_basis=v0,
        error=torch.zeros((m, n), dtype=dtype, device=dev),
        tracker=SvdState(u=u0, s=torch.zeros((rank,), dtype=dtype, device=dev), v=v0),
    )


def _orthonormalize(p):
    q, _ = torch.linalg.qr(p)
    return q


def _stack_states(states) -> CompressionState:
    return CompressionState(v_basis=torch.stack([s.v_basis for s in states]),
                            error=torch.stack([s.error for s in states]),
                            tracker=stack_trees([s.tracker for s in states]))


def _unstack_state(states: CompressionState, i: int) -> CompressionState:
    return CompressionState(v_basis=states.v_basis[i], error=states.error[i],
                            tracker=unstack_tree(states.tracker, i))


def compress_decompress(state: CompressionState, grad: torch.Tensor, *, axis_name=None,
                        update_basis: bool = True, method: str = "direct",
                        policy: UpdatePolicy | None = None, tracker_rank: int = 1):
    """Returns ``(g_hat, new_state)``.  With ``axis_name`` (a process group)
    the two factors are averaged across it.  The B=1 batched path."""
    gh, s2 = compress_decompress_batch(
        _stack_states([state]), grad[None], axis_name=axis_name, update_basis=update_basis,
        method=method, policy=policy, tracker_rank=tracker_rank)
    return gh[0], _unstack_state(s2, 0)


def compress_decompress_batch(states: CompressionState, grads: torch.Tensor, *, axis_name=None,
                              update_basis: bool = True, engine: SvdEngine | None = None,
                              method: str = "direct", policy: UpdatePolicy | None = None,
                              tracker_rank: int = 1):
    """Batched ``compress_decompress``: stacked states and grads of shape
    (B, m, n), one batched api dispatch for all B tracker updates; the
    collectives cross only ``axis_name``.  ``engine`` (legacy) overrides the
    policy-derived engine.  ``tracker_rank > 1`` absorbs the top-k
    components of the compressed gradient each step as ONE planned
    ``updates.RankK`` update instead of the single dominant one."""
    pol = _policy_for(policy, method)
    g = grads.to(states.error.dtype) + states.error                  # (B, m, n)

    # the ONLY wire traffic: two factor means, never the dense gradient
    p = collectives.pmean_factor(torch.einsum("bmn,bnr->bmr", g, states.v_basis), axis_name)
    p_hat = _orthonormalize(p)                                       # batched QR
    q = collectives.pmean_factor(torch.einsum("bmn,bmr->bnr", g, p_hat), axis_name)

    g_hat = torch.einsum("bmr,bnr->bmn", p_hat, q)
    err = g - g_hat

    tracker = states.tracker
    v_basis = states.v_basis
    if update_basis:
        # short horizon: the PowerSGD warm start (one power-iteration step an
        # optimizer step); long horizon: the streaming SVD absorbs the
        # dominant rank-1 (or top-k) of each step's compressed gradient
        v_basis = _orthonormalize(q)
        decayed = as_state(tracker).replace(s=tracker.s * 0.99)
        k = min(tracker_rank, q.shape[-1])
        if k > 1:
            # exact top-k of g_hat = p_hat @ q^T through the sketch module's
            # factored core: no dense product, no LAPACK SVD
            from repro_torch.updates.sketch import factored_svd

            uc, sig, vc = factored_svd(p_hat, q.mT, k)
            root = torch.sqrt(sig)[:, None, :]                       # (B, 1, k)
            uk, vk = uc * root, vc * root
            if engine is not None:
                from repro_torch.core.svd_update import TruncatedSvd

                t2 = TruncatedSvd(decayed.u, decayed.s, decayed.v)
                for i in range(k):
                    t2 = engine.update_truncated_batch(t2, uk[:, :, i].contiguous(),
                                                       vk[:, :, i].contiguous())
            else:
                from repro_torch.updates import RankK
                from repro_torch.updates.planner import apply as planned_apply

                t2 = planned_apply(decayed, RankK(uk, vk), pol)
        else:
            sigma = torch.linalg.vector_norm(q[:, :, 0], dim=1)     # (B,)
            u1 = p_hat[:, :, 0]                                      # (B, m)
            v1 = q[:, :, 0] / (sigma + 1e-30)[:, None]               # (B, n)
            scale = torch.sqrt(sigma)[:, None]
            if engine is not None:
                from repro_torch.core.svd_update import TruncatedSvd

                t2 = engine.update_truncated_batch(TruncatedSvd(decayed.u, decayed.s, decayed.v),
                                                   u1 * scale, v1 * scale)
            else:
                t2 = api_update(decayed, u1 * scale, v1 * scale, pol)
        tracker = _like(tracker, t2.u, t2.s, t2.v)

    return g_hat, CompressionState(v_basis=v_basis, error=err, tracker=tracker)


def refresh_basis(state: CompressionState) -> CompressionState:
    """Reset the working basis from the streaming-SVD tracker (long-horizon
    memory; call every ~100 steps to escape warm-start cycling)."""
    return CompressionState(v_basis=state.tracker.v, error=state.error, tracker=state.tracker)


def agree_tracker(tracker, *, axis_name, rank: int | None = None,
                  policy: UpdatePolicy | None = None, method: str = "direct",
                  engine: SvdEngine | None = None):
    """Consensus form of a per-worker streaming-SVD tracker (every rank of
    the group calls; ``axis_name=None`` is a local re-factorisation).

    Treats worker trackers as SVDs of the row-stacked per-worker sketches,
    gathers the small factors and merges them (``dist.merge``), then
    restricts the merged factors to this worker's row block and
    re-factorises (QR of the block and of v, and an r x r SVD), so the
    returned tracker keeps the orthonormal-basis invariant the Brand update
    needs.  Returns ``(consensus_tracker, merged)``.  A tracker with a
    leading batch axis is re-factorised member by member (local only)."""
    pol = _policy_for(policy, method)
    tr = as_state(tracker)
    m = tr.m
    if tr.is_batched:
        if axis_name is not None:
            raise ValueError("a batched tracker agrees locally only (axis_name=None)")
        merged = tracker  # the merge of one shard is the shard
    else:
        merged = dist_merge.distributed_merge(tracker, axis_name, rank=rank, policy=pol,
                                              engine=engine)
    if axis_name is None:
        u_block = merged.u
    else:
        idx = tdist.get_rank(axis_name)
        u_block = merged.u[idx * m:(idx + 1) * m]
    # local row block: M_w ~ u_block diag(s) v^T with u_block NOT orthonormal
    # and v possibly drifted off orthonormality by f32 Brand updates.
    # Re-factorise both: u_block = Qu Ru, v = Qv Rv;
    # Ru diag(s) Rv^T = P Sigma W^T  =>  M_w ~ (Qu P) Sigma (Qv W)^T.
    qu, ru = torch.linalg.qr(u_block)
    qv, rv = torch.linalg.qr(merged.v)
    p, sigma, wt = torch.linalg.svd((ru * merged.s[..., None, :]) @ rv.mT, full_matrices=False)
    return _like(tracker, qu @ p, sigma, qv @ wt.mT), merged


def agree_basis(state: CompressionState, *, axis_name, rank: int | None = None,
                engine: SvdEngine | None = None, method: str = "direct",
                policy: UpdatePolicy | None = None) -> CompressionState:
    """Cross-worker basis agreement: every worker ends with the SAME
    ``v_basis`` (the merged right basis), and the tracker becomes the
    worker's own slice of the consensus (per-worker state)."""
    tracker, merged = agree_tracker(state.tracker, axis_name=axis_name, rank=rank,
                                    policy=policy, method=method, engine=engine)
    return CompressionState(v_basis=merged.v, error=state.error, tracker=tracker)


def compressed_allreduce(states, grads, *, axis_name, method: str = "direct",
                         engine: SvdEngine | None = None, policy: UpdatePolicy | None = None,
                         tracker_rank: int = 1):
    """Tree version: 2-D leaves with a state are compressed; the others are
    averaged densely.  Compressible leaves sharing a geometry (m, n, rank,
    dtype) go through ONE ``compress_decompress_batch``."""
    pol = _policy_for(policy, method)
    flat_g = tree_leaves(grads)
    flat_s = flatten_up_to(grads, states)

    keys = [(tuple(g.shape), s.error.dtype) + truncated_geometry(s.tracker)
            if s is not None and g.dim() == 2 else None
            for g, s in zip(flat_g, flat_s)]

    out_g: list = list(flat_g)
    out_s: list = list(flat_s)
    for i, g in enumerate(flat_g):
        if keys[i] is None:
            out_g[i] = collectives.pmean_factor(g, axis_name)

    for key, idxs in group_indices(keys).items():
        if key is None:
            continue
        gh, s2 = compress_decompress_batch(
            _stack_states([flat_s[i] for i in idxs]), torch.stack([flat_g[i] for i in idxs]),
            axis_name=axis_name, engine=engine, policy=pol, tracker_rank=tracker_rank)
        for j, i in enumerate(idxs):
            out_g[i] = gh[j].to(flat_g[i].dtype)
            out_s[i] = _unstack_state(s2, j)
    return tree_unflatten(grads, out_g), tree_unflatten(grads, out_s)


def wire_bytes(m: int, n: int, rank: int, dense_dtype_bytes: int = 4) -> dict:
    dense = m * n * dense_dtype_bytes
    comp = rank * (m + n) * dense_dtype_bytes
    return {"dense": dense, "compressed": comp, "ratio": dense / comp}
