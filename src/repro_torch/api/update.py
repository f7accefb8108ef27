"""``update`` / ``update_many``: the entry points of every rank-1 update route.

Counterpart of ``repro.api.update``.  Dispatch is a function of the state's
geometry and the policy:

    state.is_full   state.is_batched   route
    -------------   ----------------   ------------------------------
    yes             no                 engine.update
    yes             yes                engine.update_batch
    no              no                 engine.update_truncated (Brand)
    no              yes                engine.update_truncated_batch

``update_rank_k`` applies k rank-1 pairs in order through the engine's
rank-k entry points; ``apply`` / ``apply_many`` (structured updates) live in
``updates.planner`` and are reached from here lazily, since the planner
builds on this module.  The update runs on the state's device.  ``warmup``
readies a (policy, geometry) pair before traffic (``SvdEngine.warmup``).
Not ported, and refused by name: mesh placement (ROADMAP A7).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.api.policy import UpdatePolicy
from repro_torch.api.state import SvdState, as_state
from repro_torch.core.engine import (
    SvdEngine,
    default_engine,
    group_indices,
    stack_trees,
    unstack_tree,
)
from repro_torch.core.svd_update import TruncatedSvd

__all__ = ["apply", "apply_many", "engine_for", "engine_from_key", "update", "update_many",
           "update_rank_k", "warmup"]

_DEFAULT_POLICY = UpdatePolicy()


def engine_from_key(policy: UpdatePolicy, problem_n: int, *, m: int | None = None,
                    n: int | None = None, rank: int | None = None) -> SvdEngine:
    """The one place a policy's ``engine_key`` unpacks into ``default_engine``
    (the trailing sketch fields key the planner's schedule cache, not the engine)."""
    method, fmm_p, sign_fix, deflate_rtol, precision, storage_dtype, _, _ = policy.engine_key(
        problem_n, m=m, n=n, rank=rank)
    return default_engine(method, fmm_p=fmm_p, sign_fix=sign_fix, deflate_rtol=deflate_rtol,
                          precision=precision, storage_dtype=storage_dtype)


def engine_for(policy: UpdatePolicy, state: SvdState) -> SvdEngine:
    """The shared engine a (policy, state geometry) pair runs on."""
    if state.is_full:
        return engine_from_key(policy, state.n, m=state.m, n=state.n)
    return engine_from_key(policy, state.rank + 1, m=state.m, n=state.n, rank=state.rank)


def _vec(x, st: SvdState) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=st.device, dtype=st.dtype)
    return torch.as_tensor(np.asarray(x), device=st.device, dtype=st.dtype)


def _prepare(state, policy: UpdatePolicy | None):
    """The policy (default filled in) and the state, cast to the policy's
    storage dtype; mesh placement is refused."""
    policy = policy if policy is not None else _DEFAULT_POLICY
    if policy.mesh is not None:
        raise NotImplementedError("mesh-sharded updates are not ported yet (ROADMAP A7)")
    st = as_state(state)
    if policy.storage_dtype is not None and st.dtype != policy.storage_dtype:
        st = st.to(policy.storage_dtype)
    return policy, st


def _finish(out: SvdState, policy: UpdatePolicy) -> SvdState:
    if policy.truncate_to is not None and policy.truncate_to < out.rank:
        out = out.truncate(policy.truncate_to)
    return out


def update(state, a, b, policy: UpdatePolicy | None = None) -> SvdState:
    """SVD of ``state + a b^T`` under ``policy``: full or truncated, single or
    stacked, decided by geometry.  ``a``: (..., m), ``b``: (..., n), with the
    leading batch axis iff the state is stacked.  Full states keep the eigen
    diagnostics."""
    policy, st = _prepare(state, policy)
    a, b = _vec(a, st), _vec(b, st)
    eng = engine_for(policy, st)
    if st.is_full:
        if st.is_batched:
            res = eng.update_batch(st.u, st.s, st.v, a, b)
        else:
            res = eng.update(st.u, st.s, st.v, a, b)
        out = SvdState(u=res.u, s=res.s, v=res.v, d_left=res.d_left, d_right=res.d_right)
    else:
        t = TruncatedSvd(u=st.u, s=st.s, v=st.v)
        if st.is_batched:
            t2 = eng.update_truncated_batch(t, a, b)
        else:
            t2 = eng.update_truncated(t, a, b)
        out = SvdState(u=t2.u, s=t2.s, v=t2.v)
    return _finish(out, policy)


def update_many(states: Sequence, A, B, policy: UpdatePolicy | None = None) -> tuple:
    """Many independent rank-1 updates in as few engine calls as possible:
    ``states[i]`` absorbs ``A[i] B[i]^T``; states sharing a geometry are
    stacked into one batched call, results come back in input order."""
    policy = policy if policy is not None else _DEFAULT_POLICY
    sts = [as_state(s) for s in states]
    if len(sts) != len(A) or len(sts) != len(B):
        raise ValueError(f"states/A/B must pair up: {len(sts)} states, {len(A)} a-vectors, "
                         f"{len(B)} b-vectors")
    for i, st in enumerate(sts):
        if st.is_batched:
            raise ValueError(f"update_many takes unbatched states; state {i} is stacked "
                             f"(u {tuple(st.u.shape)}): call update() on it directly")
    out: list = [None] * len(sts)
    for idxs in group_indices([st.geometry for st in sts]).values():
        if len(idxs) == 1:
            i = idxs[0]
            out[i] = update(sts[i], A[i], B[i], policy)
            continue
        stacked = stack_trees([SvdState(u=sts[i].u, s=sts[i].s, v=sts[i].v) for i in idxs])
        a_stack = torch.stack([_vec(A[i], sts[i]) for i in idxs])
        b_stack = torch.stack([_vec(B[i], sts[i]) for i in idxs])
        batched = update(stacked, a_stack, b_stack, policy)
        for j, i in enumerate(idxs):
            out[i] = unstack_tree(batched, j)
    return tuple(out)


def update_rank_k(state, A, B, policy: UpdatePolicy | None = None) -> SvdState:
    """SVD of ``state + A^T B`` as k rank-1 updates in row order.

    ``A``: (k, m) rows of left vectors, ``B``: (k, n) rows of right vectors,
    with a leading batch axis before k iff the state is stacked.  With
    ``truncate_to`` below the state's rank the pairs run one ``update`` at a
    time, so that the rule applies after each of them."""
    policy = policy if policy is not None else _DEFAULT_POLICY
    if policy.truncate_to is not None and policy.truncate_to < as_state(state).rank:
        out = as_state(state)
        for i in range(A.shape[-2]):
            out = update(out, A[..., i, :], B[..., i, :], policy)
        return out
    policy, st = _prepare(state, policy)
    A, B = _vec(A, st), _vec(B, st)
    eng = engine_for(policy, st)
    if st.is_full:
        if st.is_batched:
            res = eng.update_rank_k_batch(st.u, st.s, st.v, A, B)
        else:
            res = eng.update_rank_k(st.u, st.s, st.v, A, B)
        out = SvdState(u=res.u, s=res.s, v=res.v, d_left=res.d_left, d_right=res.d_right)
    else:
        t = TruncatedSvd(u=st.u, s=st.s, v=st.v)
        if st.is_batched:
            t2 = eng.update_truncated_rank_k_batch(t, A, B)
        else:
            t2 = eng.update_truncated_rank_k(t, A, B)
        out = SvdState(u=t2.u, s=t2.s, v=t2.v)
    return _finish(out, policy)


def apply(state, op, policy: UpdatePolicy | None = None) -> SvdState:
    """SVD of ``op.apply_dense(state.materialize())`` by a planned schedule of
    rank-1 updates (``updates.planner.apply``)."""
    from repro_torch.updates import planner

    return planner.apply(state, op, policy)


def apply_many(states: Sequence, ops: Sequence, policy: UpdatePolicy | None = None) -> tuple:
    """``ops[i]`` applied to ``states[i]``, same-plan groups batched
    (``updates.planner.apply_many``)."""
    from repro_torch.updates import planner

    return planner.apply_many(states, ops, policy)


def warmup(policy: UpdatePolicy, *, m: int, n: int, batch: int | None = None,
           rank: int | None = None, k: int | None = None, dtype=torch.float32, cache_dir=None,
           device="cuda"):
    """Ready the engine a (policy, geometry) pair will use before traffic
    arrives (serving cold-start control): its geometry-cache entry and, on a
    card, the built and loaded libraries of the route's kernels.
    ``rank=None`` warms the full route, else the truncated one;
    ``batch=None`` the single form; ``k`` the rank-k form.  With
    ``policy.storage_dtype`` set the warmed geometry uses the storage dtype.

    ``cache_dir`` points the kernels' build cache there
    (``api.cache.enable_compilation_cache``): a later process warming the
    same route loads the libraries compiled there instead of running nvcc.

    >>> from repro_torch import api
    >>> pol = api.UpdatePolicy(method="direct")
    >>> info = api.warmup(pol, m=4, n=5, rank=2, dtype=torch.float64, device="cpu")
    >>> info.entries >= 1
    True
    """
    if cache_dir is not None:
        from repro_torch.api.cache import enable_compilation_cache

        enable_compilation_cache(cache_dir)
    if policy.mesh is not None:
        raise NotImplementedError("mesh-sharded updates are not ported yet (ROADMAP A7)")
    if policy.storage_dtype is not None:
        dtype = policy.storage_dtype
    eng = engine_from_key(policy, n if rank is None else rank + 1, m=m, n=n, rank=rank)
    return eng.warmup(batch=batch, m=m, n=n, rank=rank, k=k, dtype=dtype, device=device)
