"""Hierarchical truncated-SVD merge (Iwen & Ong, arXiv:1601.07010), built
from the paper's rank-1 updates, in PyTorch.

Counterpart of ``repro.dist.merge``.  ``W`` row blocks ``M_i`` each carry a
truncated SVD ``(U_i, S_i, V_i)``; the merge finds the rank-r SVD of
``M = [M_1; ...; M_W]`` without forming ``M``.  For one pair ``[A; B]``

    [A; B] = [[U_a, 0], [0, U_b]] @ K,    K = [[S_a V_a^T], [S_b V_b^T]]

so the merge is the SVD of the small ``(r_a + r_b, n)`` core ``K``, built by
rank-1 updates: start from ``[S_a V_a^T; 0]`` (bases ``u = [I; 0]``,
``v = V_a``) and absorb B's components one at a time,
``K <- K + (s_i e_{r_a + i}) v_i^T``, each a batched truncated-update engine
call (kernel B on a card under ``method="fused"``).  For a globally rank-<=r
matrix each truncation discards an exact zero and the merge is exact.

The cores are updated in float64 whatever the shards' dtype, and the result
comes back in the shards' dtype.  Algorithm 6.1 squares the spectrum, so a
float32 step loses about ``(s_1 / s_r)^2 eps`` of the left factor, and a merge
chains ``r_b`` such steps a level: on exactly low-rank shards the reference's
float32 ``merge_tree`` misses the stacked matrix's left singular subspace by
0.14 RMS sine (``tools/port_vs_reference.py --part merge``).  The cores are
small (``r_a + r_b`` rows); the lift through the shards' own left bases stays
in their dtype.

``merge_tree`` reduces a shard list pairwise in log depth, all the pairs of
a level through ONE batched engine call per rank-1 step; equal-geometry
lists of non-power-of-two length are padded with zero shards (sliced off the
result), so every level runs batched.  Genuinely mixed heights merge through
the planner's ``AppendRows`` lowering (``merge_append``).  Each level is a
``merge_level`` span and bumps the ``merge_levels`` / ``merge_pairs`` /
``merge_wire_bytes`` counters when observability is on.

``distributed_merge`` (the cross-card form: an all-gather of the factors,
then this tree on every worker) is refused by name until the mesh tier is
ported (ROADMAP A7).  Shards may be ``SvdState`` or ``TruncatedSvd``; the
result comes back in the container type of the first shard.
"""

from __future__ import annotations

import torch

from repro_torch import obs as _obs
from repro_torch.api.policy import UpdatePolicy, policy_from_legacy
from repro_torch.api.state import SvdState, like_container as _like
from repro_torch.api.update import engine_from_key
from repro_torch.core.engine import SvdEngine, stack_trees, unstack_tree
from repro_torch.core.svd_update import TruncatedSvd
from repro_torch.dist.collectives import factor_wire_bytes
from repro_torch.updates.ops import AppendRows
from repro_torch.updates.planner import apply as _planned_apply

__all__ = ["distributed_merge", "merge_append", "merge_pair", "merge_tree"]

# the dtype the merge cores are updated in (see the module docstring)
_CORE_DTYPE = torch.float64


def _engine_from(engine: SvdEngine | None, policy: UpdatePolicy | None, method: str,
                 rank: int) -> SvdEngine:
    """Engine for the merge's truncated core updates: explicit ``engine`` >
    ``policy`` > legacy ``method`` string, all on the shared default engines."""
    if engine is not None:
        return engine
    return engine_from_key(policy_from_legacy(policy, method), rank + 1)


def _merge_cores_batched(a_stack: TruncatedSvd, b_stack: TruncatedSvd,
                         engine: SvdEngine) -> TruncatedSvd:
    """SVDs of the stacked cores ``K_p = [S_a V_a^T; S_b V_b^T]`` for P pairs
    of one geometry: each of the ``r_b`` rank-1 absorptions is one batched
    engine call."""
    p_pairs, _, r_a = a_stack.u.shape
    r_b = b_stack.s.shape[1]
    dt, dev = _CORE_DTYPE, a_stack.u.device
    rows = r_a + r_b

    # [S_a V_a^T; 0] at rank r_a with orthonormal bases (never pad the state
    # with zero columns: the Brand augmentation needs orthonormal bases)
    u0 = torch.eye(rows, r_a, dtype=dt, device=dev).expand(p_pairs, rows, r_a).contiguous()
    core = TruncatedSvd(u=u0, s=a_stack.s.to(dt), v=a_stack.v.to(dt))
    b_s, b_v = b_stack.s.to(dt), b_stack.v.to(dt)
    for i in range(r_b):
        # s_i e_{r_a+i} v_i^T: the e-vector lands on B's untouched row block
        e_i = torch.zeros((p_pairs, rows), dtype=dt, device=dev)
        e_i[:, r_a + i] = b_s[:, i]
        core = engine.update_truncated_batch(core, e_i, b_v[:, :, i].contiguous())
    return core


def _combine_bases(a, b, core: TruncatedSvd, rank: int):
    """Lift the core SVD back through the block-diagonal left bases."""
    r_a = a.s.shape[0]
    uk = core.u[:, :rank].to(a.u.dtype)
    u = torch.cat([a.u @ uk[:r_a], b.u @ uk[r_a:]], dim=0)
    return _like(a, u, core.s[:rank].to(a.s.dtype), core.v[:, :rank].to(a.v.dtype))


def _check_pair(a, b, rank: int | None) -> int:
    if a.v.shape[0] != b.v.shape[0]:
        raise ValueError(f"row-concatenated shards must share the column space: "
                         f"n={a.v.shape[0]} vs {b.v.shape[0]}")
    r_a = a.s.shape[0]
    r = rank if rank is not None else r_a
    if r > r_a:
        raise ValueError(f"merge rank {r} exceeds the left shard's rank {r_a}; the core "
                         f"state carries rank r_a — order the higher-rank shard first")
    return r


def merge_pair(a, b, *, rank: int | None = None, engine: SvdEngine | None = None,
               method: str = "direct", policy: UpdatePolicy | None = None):
    """Rank-``rank`` truncated SVD of the row concatenation ``[A; B]``;
    ``rank`` defaults to (and may not exceed) ``r_a``."""
    r = _check_pair(a, b, rank)
    engine = _engine_from(engine, policy, method, a.s.shape[0])
    a_stack = TruncatedSvd(a.u[None], a.s[None], a.v[None])
    b_stack = TruncatedSvd(b.u[None], b.s[None], b.v[None])
    core = unstack_tree(_merge_cores_batched(a_stack, b_stack, engine), 0)
    return _combine_bases(a, b, core, r)


def merge_append(a, b, *, rank: int | None = None, policy: UpdatePolicy | None = None):
    """Rank-``rank`` truncated SVD of ``[A; B]`` through the planner: ``B`` is
    an ``AppendRows.from_svd`` op on ``A``'s state (the path ``merge_tree``
    takes for mixed shard heights)."""
    r = _check_pair(a, b, rank)
    wide = [x.to(_CORE_DTYPE) for x in (a.u, a.s, a.v, b.u, b.s, b.v)]
    out = _planned_apply(SvdState(*wide[:3]), AppendRows.from_svd(*wide[3:]),
                         policy_from_legacy(policy))
    return _like(a, out.u[:, :r].to(a.u.dtype), out.s[:r].to(a.s.dtype),
                 out.v[:, :r].to(a.v.dtype))


def _pad_to_pow2(shards: list) -> tuple[list, int]:
    """Append zero shards (``s = 0``, zero left rows, the last shard's
    orthonormal ``v``) until the count is a power of two; they stay at the
    bottom through every ordered level and are sliced off by the caller.
    Returns (padded shard list, number of real rows)."""
    w = len(shards)
    real_rows = sum(int(t.u.shape[0]) for t in shards)
    target = 1
    while target < w:
        target <<= 1
    if target == w:
        return shards, real_rows
    tmpl = shards[-1]
    zero = _like(tmpl, torch.zeros_like(tmpl.u), torch.zeros_like(tmpl.s), tmpl.v)
    return shards + [zero] * (target - w), real_rows


def merge_tree(shards, *, rank: int | None = None, engine: SvdEngine | None = None,
               method: str = "direct", policy: UpdatePolicy | None = None):
    """Log-depth pairwise merge of row-partitioned truncated SVDs.

    ``shards`` are ordered row blocks.  Each level pairs neighbours and
    merges all equal-geometry pairs through one batched engine call per
    rank-1 step; mixed geometries merge pairwise through ``merge_append``
    (``merge_pair`` when the caller pinned an engine), an odd tail riding up
    a level.  Depth is ``ceil(log2 W)``.
    """
    shards = list(shards)
    if not shards:
        raise ValueError("merge_tree needs at least one shard")
    r_min = min(int(t.s.shape[0]) for t in shards)
    if rank is None:
        rank = r_min
    elif rank > r_min:
        raise ValueError(f"merge rank {rank} exceeds the smallest shard rank {r_min}; "
                         f"the pairwise core state cannot carry more than the shard rank")
    explicit_engine = engine
    pol = policy_from_legacy(policy, method)
    engine = _engine_from(engine, policy, method, r_min)

    real_rows = None
    if len(shards) > 1:
        geoms = {(tuple(t.u.shape), tuple(t.s.shape), tuple(t.v.shape)) for t in shards}
        if len(geoms) == 1:
            shards, real_rows = _pad_to_pow2(shards)

    level = 0
    while len(shards) > 1:
        pairs = [(shards[i], shards[i + 1]) for i in range(0, len(shards) - 1, 2)]
        tail = [shards[-1]] if len(shards) % 2 else []
        geoms = {(tuple(p[0].u.shape), tuple(p[1].u.shape)) for p in pairs}
        # what this level's factor exchange would cost over the wire (the
        # first pair's geometry as representative), for the trace
        wires = factor_wire_bytes(
            int(pairs[0][0].u.shape[0]) + int(pairs[0][1].u.shape[0]),
            int(pairs[0][0].v.shape[0]), rank, n_workers=len(pairs) * 2,
            itemsize=pairs[0][0].u.element_size())
        with _obs.span("merge_level", level=level, pairs=len(pairs), batched=len(geoms) == 1,
                       **wires):
            if len(geoms) == 1:
                a_stack = stack_trees([TruncatedSvd(p[0].u, p[0].s, p[0].v) for p in pairs])
                b_stack = stack_trees([TruncatedSvd(p[1].u, p[1].s, p[1].v) for p in pairs])
                cores = _merge_cores_batched(a_stack, b_stack, engine)
                merged = [_combine_bases(p[0], p[1], unstack_tree(cores, j), rank)
                          for j, p in enumerate(pairs)]
            elif explicit_engine is not None:
                # the planner resolves engines from the policy only, so a
                # caller-pinned engine keeps the small-core pairwise path
                merged = [merge_pair(x, y, rank=rank, engine=engine) for x, y in pairs]
            else:
                merged = [merge_append(x, y, rank=rank, policy=pol) for x, y in pairs]
        if _obs.enabled():
            reg = _obs.registry()
            reg.counter("merge_levels").inc()
            reg.counter("merge_pairs").inc(len(pairs))
            reg.counter("merge_wire_bytes",
                        kind="factor_allgather").inc(int(wires["factor_allgather"]))
            reg.counter("merge_wire_bytes",
                        kind="dense_allreduce").inc(int(wires["dense_allreduce"]))
        shards = merged + tail
        level += 1

    out = shards[0]
    if real_rows is not None and out.u.shape[0] != real_rows:
        out = _like(out, out.u[:real_rows], out.s, out.v)
    return out


def distributed_merge(local, axis_name, *, rank: int | None = None,
                      engine: SvdEngine | None = None, method: str = "direct",
                      policy: UpdatePolicy | None = None):
    """Merge per-worker truncated SVDs across cards (not ported: ROADMAP A7)."""
    raise NotImplementedError(
        "distributed_merge needs the mesh tier, which is not ported yet (ROADMAP A7); "
        "merge_tree merges shards that live in one process")
