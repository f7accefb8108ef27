"""Lowering structured-perturbation ops onto the rank-1 engine.

Counterpart of ``repro.updates.planner``.  ``apply(state, op, policy)``
compiles any ``updates.ops`` op into a schedule of ``api`` calls and runs it:

* ``RankK``      -> k rank-1 ``api.update`` steps (one ``api.update_rank_k``
  step from ``_SCAN_MIN`` components on);
* ``DenseDelta`` -> top-``rank`` sketch of the delta (``sketch.sketch_svd``),
  then rank-1 steps;
* ``Sparse``     -> top-``rank`` sketch through kernel F
  (``sketch.sparse_sketch_svd``), never densifying m x n;
* ``AppendRows`` / ``AppendCols`` -> zero-pad the geometry, then one rank-1
  step per component of the appended block;
* ``Decay``      -> folded into the singular values, no engine dispatch;
* ``RemoveRows`` / ``RemoveCols`` -> one rank-1 step per deleted index that
  zeroes the slice (``A - (A e_j) e_j^T``, bound from the current factors),
  then a free shrink of the factor;
* ``Window``     -> decay fold plus RemoveRows of the oldest rows;
* ``Compose``    -> the children's schedules in order.

``apply_many(states, ops, policy)`` stacks the states that share a geometry
and a schedule and runs the schedule once for the whole group: every rank-1
step is one batched engine call.  Schedules are cached by ``(op.spec(),
geometry, rank, is_full, sketch_params)`` (``schedule_cache_info``).

Op data moves to the state's device (and dtype; float32 for 16-bit storage)
when a step binds it, so a ``Sparse`` op applied to a state on the card runs
its projections through kernel F.  With observability on, ``lower`` counts
``planner_schedule_cache_hits`` / ``_misses`` and times each new schedule
under a ``schedule_compile`` span; ``warmup_plan`` readies every engine
geometry and sketch a schedule will run, before traffic.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.api.policy import UpdatePolicy
from repro_torch.api.state import SvdState, as_state
from repro_torch.api.update import update, update_rank_k, warmup
from repro_torch.updates.ops import AppendCols, AppendRows, DenseDelta, Sparse, UpdateOp
from repro_torch.updates.sketch import sketch_svd, sparse_sketch_svd, warmup_sketch

__all__ = [
    "apply",
    "apply_many",
    "lower",
    "op_low_rank_factors",
    "schedule_cache_clear",
    "schedule_cache_info",
    "warmup_plan",
]

_DEFAULT_SKETCH = UpdatePolicy().sketch_params


def _sketch_params(policy: UpdatePolicy | None) -> tuple[int, int]:
    return _DEFAULT_SKETCH if policy is None else policy.sketch_params


class ScheduleCacheInfo(NamedTuple):
    hits: int
    misses: int
    entries: int


_cache: dict[tuple, tuple] = {}
_hits = 0
_misses = 0
_lock = threading.Lock()


def schedule_cache_info() -> ScheduleCacheInfo:
    with _lock:
        return ScheduleCacheInfo(_hits, _misses, len(_cache))


def schedule_cache_clear() -> None:
    global _hits, _misses
    with _lock:
        _cache.clear()
        _hits = 0
        _misses = 0


# -- lowering: op spec -> schedule of abstract steps ----------------------------
#
#   ("decay", path)                 s *= lam            (free)
#   ("pad_rows", p) / ("pad_cols", p)                   (free)
#   ("drop_rows", idx) / ("drop_cols", idx)             (free shrink)
#   ("rank1", path, kind, i)        one engine dispatch
#   ("rank1_scan", path, kind, k)   k dispatches through api.update_rank_k
#
# ``path`` locates the source op inside Compose nesting; ``i`` names the
# component.  Steps hold no data: it binds at execution.  Downdate kinds bind
# their pairs from the CURRENT state's factors: zeroing one slice leaves every
# other untouched, so all pairs of a step bind from the same factors.  Runs of
# _SCAN_MIN or more components lower to one rank-k step, as in the reference.

_SCAN_MIN = 17

# rank-1 kinds whose (a, b) pairs bind from the current state, not op data
_REMOVE_KINDS = ("remove_rows", "remove_cols", "window_rows")


def _step_policy(policy: UpdatePolicy | None, step: tuple) -> UpdatePolicy | None:
    """Engine policy for one lowered step.

    Downdate steps pin the phase-chain route under ``auto``: zeroing a slice
    leaves every untouched singular value exactly in place, and the fused
    kernel's independent left/right pole merges may pair u and v
    inconsistently inside such a degenerate group.  An explicit method is
    honoured."""
    if step[2] not in _REMOVE_KINDS:
        return policy
    if policy is None:
        return UpdatePolicy(method="direct")
    if policy.method == "auto":
        return policy.replace(method="direct")
    return policy


def _component_steps(path: tuple, kind: str, count: int) -> list:
    if count >= _SCAN_MIN:
        return [("rank1_scan", path, kind, count)]
    return [("rank1", path, kind, i) for i in range(count)]


def _build(spec: tuple, m: int, n: int, rank: int, is_full: bool, path: tuple):
    kind = spec[0]
    if kind == "rank_k":
        return _component_steps(path, kind, spec[1]), (m, n)
    if kind == "dense_delta":
        return _component_steps(path, kind, spec[1]), (m, n)
    if kind == "sparse":
        return _component_steps(path, kind, spec[2]), (m, n)
    if kind == "decay":
        return [("decay", path)], (m, n)
    if kind in ("append_rows", "append_cols"):
        if is_full:
            raise ValueError(
                f"{kind} requires a truncated state: a full (square-basis) "
                f"state cannot zero-pad its geometry — truncate first")
        p, q = spec[1], spec[2]
        pad = ("pad_rows", p) if kind == "append_rows" else ("pad_cols", p)
        out = (m + p, n) if kind == "append_rows" else (m, n + p)
        return [pad] + _component_steps(path, kind, q), out
    if kind in ("remove_rows", "remove_cols"):
        if is_full:
            raise ValueError(
                f"{kind} requires a truncated state: a full (square-basis) "
                f"state cannot shrink its geometry — truncate first")
        idx = spec[1]
        axis, dim = ("rows", m) if kind == "remove_rows" else ("cols", n)
        if idx[-1] >= dim:
            raise ValueError(f"{kind} index {idx[-1]} out of range for {dim} {axis}")
        out = (m - len(idx), n) if kind == "remove_rows" else (m, n - len(idx))
        if rank > min(out):
            raise ValueError(
                f"{kind}{idx} shrinks the geometry to {out}, below the "
                f"state's rank {rank} — truncate first")
        drop = ("drop_rows", idx) if kind == "remove_rows" else ("drop_cols", idx)
        return _component_steps(path, kind, len(idx)) + [drop], out
    if kind == "window":
        if is_full:
            raise ValueError(
                "window requires a truncated state: a full (square-basis) "
                "state cannot shrink its geometry — truncate first")
        size = spec[1]
        cut = m - size
        steps = [("decay", path)]
        if cut <= 0:
            return steps, (m, n)
        out = (size, n)
        if rank > min(out):
            raise ValueError(
                f"window({size}) shrinks the geometry to {out}, below the "
                f"state's rank {rank} — truncate first")
        steps += _component_steps(path, "window_rows", cut)
        steps.append(("drop_rows", tuple(range(cut))))
        return steps, out
    if kind == "compose":
        steps: list = []
        for j, child in enumerate(spec[1]):
            sub, (m, n) = _build(child, m, n, rank, is_full, path + (j,))
            steps.extend(sub)
        return steps, (m, n)
    raise ValueError(f"unknown op spec {spec!r}")


def lower(op: UpdateOp, state, policy: UpdatePolicy | None = None) -> tuple:
    """The cached schedule for ``op`` applied to ``state``'s geometry; the
    key folds the policy's ``sketch_params``.

    >>> import numpy as np
    >>> from repro_torch.api import SvdState
    >>> from repro_torch.updates.ops import Compose, Decay, RankK
    >>> st = SvdState.from_dense(np.eye(4, 6), rank=2, device="cpu")
    >>> op = Compose((Decay(0.9), RankK(np.zeros((4, 2)), np.zeros((6, 2)))))
    >>> lower(op, st)
    (('decay', (0,)), ('rank1', (1,), 'rank_k', 0), ('rank1', (1,), 'rank_k', 1))
    """
    global _hits, _misses
    st = as_state(state)
    key = (op.spec(), st.m, st.n, st.rank, st.is_full, _sketch_params(policy))
    with _lock:
        plan = _cache.get(key)
        if plan is not None:
            _hits += 1
        else:
            _misses += 1
    if plan is not None:
        if _obs.enabled():
            _obs.registry().counter("planner_schedule_cache_hits").inc()
        return plan
    if _obs.enabled():
        _obs.registry().counter("planner_schedule_cache_misses").inc()
    with _obs.span("schedule_compile", op=key[0][0], m=st.m, n=st.n, rank=st.rank):
        steps, _ = _build(key[0], st.m, st.n, st.rank, st.is_full, ())
    plan = tuple(steps)
    with _lock:
        _cache[key] = plan
    return plan


# -- execution: bind step data from the op, dispatch through the api -------------


def _resolve(op: UpdateOp, path: tuple) -> UpdateOp:
    for j in path:
        op = op.ops[j]
    return op


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype op data binds in: the state's, float32 for 16-bit storage."""
    return torch.float32 if dtype.itemsize <= 2 else dtype


def _on(x, device, dtype) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def op_low_rank_factors(op, m: int, n: int, policy: UpdatePolicy | None = None, *,
                        device=None, dtype=torch.float64):
    """(u, s, v) rank-1 components of an op's low-rank block at geometry
    (m, n), with the op's data on ``device`` in ``dtype`` (``device=None``:
    where a tensor already lies, else the CPU).

    ``DenseDelta`` sketches at its rank budget; ``Sparse`` sketches through
    kernel F; dense append blocks sketch at their full block rank (exact);
    pre-factored append blocks bind as carried."""
    oversample, power_iters = _sketch_params(policy)

    def on(x):
        dev = device if device is not None else getattr(x, "device", "cpu")
        return _on(x, dev, dtype)

    if isinstance(op, DenseDelta):
        return sketch_svd(on(op.delta), op.rank, oversample=oversample,
                          power_iters=power_iters)
    if isinstance(op, Sparse):
        # single-pass two-sided sketch: no power_iters knob
        vals = on(op.vals)
        rows, cols = (_on(x, vals.device, torch.int32) for x in (op.rows, op.cols))
        return sparse_sketch_svd(rows, cols, vals, m=m, n=n, k=op.rank,
                                 oversample=oversample)
    if isinstance(op, AppendRows) and op.rows is not None:
        return sketch_svd(on(op.rows), op.block_rank, oversample=oversample,
                          power_iters=power_iters)
    if isinstance(op, AppendCols) and op.cols is not None:
        return sketch_svd(on(op.cols), op.block_rank, oversample=oversample,
                          power_iters=power_iters)
    if isinstance(op, (AppendRows, AppendCols)):  # pre-factored block
        return on(op.u), on(op.s), on(op.v)
    raise TypeError(f"{type(op).__name__} has no low-rank block to extract")


def _block_factors(op, ctx: dict, path: tuple, cur: SvdState, policy: UpdatePolicy | None):
    """Per-apply memo over ``op_low_rank_factors`` (one sketch per block).
    ``Sparse`` needs the CURRENT geometry (appends earlier in a Compose may
    have grown it)."""
    key = (path, "factors")
    if key not in ctx:
        ctx[key] = op_low_rank_factors(op, cur.m, cur.n, policy, device=cur.device,
                                       dtype=_work_dtype(cur.dtype))
    return ctx[key]


def _rank_k_factors(op, ctx: dict, path: tuple, cur: SvdState):
    """A ``RankK``'s (u, v) on the state's device, converted once per apply."""
    key = (path, "uv")
    if key not in ctx:
        dt = _work_dtype(cur.dtype)
        ctx[key] = (_on(op.u, cur.device, dt), _on(op.v, cur.device, dt))
    return ctx[key]


def _zeros_like_batch(ref: torch.Tensor, length: int) -> torch.Tensor:
    """Zeros with ``ref``'s leading (batch) dims and a trailing ``length``."""
    return ref.new_zeros(ref.shape[:-1] + (length,))


def _one_hot(cur: SvdState, dim: int, j: int) -> torch.Tensor:
    """``e_j`` of length ``dim`` over ``cur``'s batch dims."""
    z = cur.s.new_zeros(cur.s.shape[:-1] + (dim,))
    z[..., j] = 1.0
    return z


def _remove_index(src: UpdateOp, kind: str, i: int) -> int:
    """The matrix index zeroed by component ``i`` of a downdate step."""
    return i if kind == "window_rows" else src.idx[i]


def _bind_remove(cur: SvdState, src: UpdateOp, kind: str, i: int):
    """(a, b) zeroing one row or column of the CURRENT state:

    column j:  A - (A e_j) e_j^T   with A e_j   = U (s * V[j, :]);
    row i:     A - e_i (A^T e_i)^T with A^T e_i = V (s * U[i, :]).
    Batch-generic: it binds off a stacked state too."""
    j = _remove_index(src, kind, i)
    if kind == "remove_cols":
        a = -(cur.u @ (cur.s * cur.v[..., j, :])[..., None])[..., 0]
        return a, _one_hot(cur, cur.n, j)
    b = -(cur.v @ (cur.s * cur.u[..., j, :])[..., None])[..., 0]
    return _one_hot(cur, cur.m, j), b


def _bind_remove_block(cur: SvdState, src: UpdateOp, kind: str, count: int):
    """All ``count`` downdate pairs at once, shaped (…, k, m) / (…, k, n): the
    slices never overlap, so every pair reads the same (current) factors."""
    idx = tuple(range(count)) if kind == "window_rows" else src.idx
    take = torch.tensor(idx, dtype=torch.long, device=cur.device)
    dim = cur.n if kind == "remove_cols" else cur.m
    eye = cur.s.new_zeros((count, dim))
    eye[torch.arange(count, device=cur.device), take] = 1.0
    eye = eye.expand(cur.s.shape[:-1] + (count, dim))
    if kind == "remove_cols":
        vj = cur.v.index_select(-2, take)                          # (..., k, r)
        return -(cur.s[..., None, :] * vj) @ cur.u.mT, eye
    uj = cur.u.index_select(-2, take)
    return eye, -(cur.s[..., None, :] * uj) @ cur.v.mT


def _bind(cur: SvdState, op: UpdateOp, step: tuple, ctx: dict,
          policy: UpdatePolicy | None = None):
    """The (a, b) pair of one rank-1 step, shaped for the CURRENT geometry."""
    _, path, kind, i = step
    src = _resolve(op, path)
    if kind in _REMOVE_KINDS:
        return _bind_remove(cur, src, kind, i)
    if kind == "rank_k":
        u, v = _rank_k_factors(src, ctx, path, cur)
        return u[..., :, i], v[..., :, i]
    u, s, v = _block_factors(src, ctx, path, cur, policy)
    comp = u[..., :, i] * s[..., i:i + 1]
    if kind in ("dense_delta", "sparse"):
        return comp, v[..., :, i]
    if kind == "append_rows":
        # the block's rows live at the bottom of the (already padded) state
        return torch.cat([_zeros_like_batch(comp, cur.m - src.p), comp], dim=-1), v[..., :, i]
    # append_cols: the block's columns live at the right edge
    v_i = v[..., :, i]
    return comp, torch.cat([_zeros_like_batch(v_i, cur.n - src.p), v_i], dim=-1)


def _bind_block(cur: SvdState, op: UpdateOp, step: tuple, ctx: dict,
                policy: UpdatePolicy | None = None):
    """The full (k, m) / (k, n) pair blocks of one rank-k step."""
    _, path, kind, count = step
    src = _resolve(op, path)
    if kind in _REMOVE_KINDS:
        return _bind_remove_block(cur, src, kind, count)
    if kind == "rank_k":
        u, v = _rank_k_factors(src, ctx, path, cur)
        return u.mT, v.mT
    u, s, v = _block_factors(src, ctx, path, cur, policy)
    comp = (u * s[..., None, :]).mT                          # (..., k, rows)
    vt = v.mT                                                # (..., k, cols)
    if kind in ("dense_delta", "sparse"):
        return comp, vt
    if kind == "append_rows":
        return torch.cat([_zeros_like_batch(comp, cur.m - src.p), comp], dim=-1), vt
    return comp, torch.cat([_zeros_like_batch(vt, cur.n - src.p), vt], dim=-1)


def _pad_rows(cur: SvdState, p: int) -> SvdState:
    return cur.replace(u=torch.cat([cur.u, cur.u.new_zeros(cur.u.shape[:-2] + (p, cur.rank))],
                                   dim=-2))


def _pad_cols(cur: SvdState, p: int) -> SvdState:
    return cur.replace(v=torch.cat([cur.v, cur.v.new_zeros(cur.v.shape[:-2] + (p, cur.rank))],
                                   dim=-2))


def _keep(length: int, idx: tuple, device) -> torch.Tensor:
    drop = set(idx)
    return torch.tensor([i for i in range(length) if i not in drop], dtype=torch.long,
                        device=device)


def _drop_rows(cur: SvdState, idx: tuple) -> SvdState:
    """Shrink the geometry by deleting (already zeroed) rows of ``u``."""
    return cur.replace(u=cur.u.index_select(-2, _keep(cur.m, idx, cur.device)))


def _drop_cols(cur: SvdState, idx: tuple) -> SvdState:
    """Shrink the geometry by deleting (already zeroed) rows of ``v``."""
    return cur.replace(v=cur.v.index_select(-2, _keep(cur.n, idx, cur.device)))


_GEOMETRY_STEPS = {"pad_rows": _pad_rows, "pad_cols": _pad_cols, "drop_rows": _drop_rows,
                   "drop_cols": _drop_cols}


def _exec_free(cur: SvdState, op: UpdateOp, step: tuple) -> SvdState:
    """Execute a zero-dispatch step (decay fold, geometry pad or shrink)."""
    if step[0] == "decay":
        lam = _on(_resolve(op, step[1]).lam, cur.device, cur.s.dtype)
        return cur.replace(s=cur.s * lam)
    return _GEOMETRY_STEPS[step[0]](cur, step[1])


def apply(state, op: UpdateOp, policy: UpdatePolicy | None = None) -> SvdState:
    """SVD of ``op.apply_dense(state.materialize())`` by planned rank-1
    updates (also ``repro_torch.api.apply``).  ``state`` is full or
    truncated, single or stacked; geometry and policy pick each step's route
    as in ``api.update``.  Appends, removes and windows need a truncated state.

    >>> import numpy as np
    >>> from repro_torch import api
    >>> from repro_torch.updates import RankK
    >>> rng = np.random.default_rng(0)
    >>> x = rng.normal(size=(4, 6))
    >>> uk, vk = rng.normal(size=(4, 2)), rng.normal(size=(6, 2))
    >>> out = api.apply(api.SvdState.from_dense(x, device="cpu"), RankK(uk, vk))
    >>> ref = np.linalg.svd(x + uk @ vk.T, compute_uv=False)
    >>> bool(np.allclose(out.s.numpy(), ref, atol=1e-9))
    True
    """
    st = as_state(state)
    plan = lower(op, st, policy)
    ctx: dict = {}
    for step in plan:
        if step[0] == "rank1":
            a, b = _bind(st, op, step, ctx, policy)
            st = update(st, a, b, _step_policy(policy, step))
        elif step[0] == "rank1_scan":
            va, vb = _bind_block(st, op, step, ctx, policy)
            st = update_rank_k(st, va, vb, _step_policy(policy, step))
        else:
            st = _exec_free(st, op, step)
    return st


def _group_pairs(cur: SvdState, group_ops: list, ctxs: list, step: tuple, bind,
                 policy: UpdatePolicy | None):
    """The stacked (a, b) of one step for a whole group.  Downdate pairs bind
    from the state, once, off the stacked state (the plan fixes the indices,
    so every member shares them); the others bind per member from op data
    (binding reads only the shared geometry off ``cur``)."""
    if step[2] in _REMOVE_KINDS:
        return bind(cur, group_ops[0], step, ctxs[0], policy)
    pairs = [bind(cur, op, step, ctx, policy) for op, ctx in zip(group_ops, ctxs)]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def apply_many(states: Sequence, ops: Sequence[UpdateOp],
               policy: UpdatePolicy | None = None) -> tuple[SvdState, ...]:
    """Apply ``ops[i]`` to ``states[i]``.  States that share a geometry and a
    schedule are stacked once and run the schedule together: each rank-1
    step is one batched engine call for the whole group, so a rank-k update
    of B streams costs k batched calls, not B*k single ones.

    >>> import numpy as np
    >>> from repro_torch import api
    >>> from repro_torch.updates import Decay, RankK
    >>> rng = np.random.default_rng(1)
    >>> sts = [api.SvdState.from_dense(rng.normal(size=(4, 5)), rank=3, device="cpu")
    ...        for _ in range(3)]
    >>> ops = [RankK(rng.normal(size=(4, 2)), rng.normal(size=(5, 2))),
    ...        RankK(rng.normal(size=(4, 2)), rng.normal(size=(5, 2))),
    ...        Decay(0.5)]
    >>> outs = api.apply_many(sts, ops)
    >>> len(outs), outs[2].rank
    (3, 3)
    """
    sts = [as_state(s) for s in states]
    if len(sts) != len(ops):
        raise ValueError(f"{len(sts)} states but {len(ops)} ops")
    for i, st in enumerate(sts):
        if st.is_batched:
            raise ValueError(f"apply_many takes unbatched states; state {i} is stacked "
                             f"(u {tuple(st.u.shape)}): call apply() on it directly")
    plans = [lower(op, st, policy) for op, st in zip(ops, sts)]

    out: list[SvdState | None] = [None] * len(sts)
    groups: dict[tuple, list[int]] = {}
    for i, (st, plan) in enumerate(zip(sts, plans)):
        groups.setdefault((st.geometry, plan), []).append(i)

    for (_, plan), idxs in groups.items():
        if len(idxs) == 1:
            i = idxs[0]
            out[i] = apply(sts[i], ops[i], policy)
            continue
        group_ops = [ops[i] for i in idxs]
        ctxs: list[dict] = [{} for _ in idxs]
        cur = SvdState(u=torch.stack([sts[i].u for i in idxs]),
                       s=torch.stack([sts[i].s for i in idxs]),
                       v=torch.stack([sts[i].v for i in idxs]))
        for step in plan:
            if step[0] == "rank1":
                a, b = _group_pairs(cur, group_ops, ctxs, step, _bind, policy)
                cur = update(cur, a, b, _step_policy(policy, step))
            elif step[0] == "rank1_scan":
                va, vb = _group_pairs(cur, group_ops, ctxs, step, _bind_block, policy)
                cur = update_rank_k(cur, va, vb, _step_policy(policy, step))
            elif step[0] == "decay":
                lams = torch.stack([_on(_resolve(op, step[1]).lam, cur.device, cur.s.dtype)
                                    for op in group_ops])
                cur = cur.replace(s=cur.s * lams[:, None])
            else:
                cur = _GEOMETRY_STEPS[step[0]](cur, step[1])
        for j, i in enumerate(idxs):
            out[i] = SvdState(u=cur.u[j], s=cur.s[j], v=cur.v[j], mesh=sts[i].mesh)
    return tuple(out)


def _sketch_sites(spec: tuple, m: int, n: int):
    """Sketch geometries ``(m, n, k, nnz-or-None)`` the schedule will run,
    threading geometry through appends exactly like ``_build``."""
    kind = spec[0]
    if kind == "dense_delta":
        return [(m, n, spec[1], None)], (m, n)
    if kind == "sparse":
        return [(m, n, spec[2], spec[1])], (m, n)
    if kind == "append_rows":
        sites = [(spec[1], n, spec[2], None)] if spec[3] == "dense" else []
        return sites, (m + spec[1], n)
    if kind == "append_cols":
        sites = [(m, spec[1], spec[2], None)] if spec[3] == "dense" else []
        return sites, (m, n + spec[1])
    if kind == "remove_rows":
        return [], (m - len(spec[1]), n)
    if kind == "remove_cols":
        return [], (m, n - len(spec[1]))
    if kind == "window":
        return [], (min(m, spec[1]), n)
    if kind == "compose":
        sites: list = []
        for child in spec[1]:
            sub, (m, n) = _sketch_sites(child, m, n)
            sites.extend(sub)
        return sites, (m, n)
    return [], (m, n)  # rank_k / decay: no extraction


def warmup_plan(policy: UpdatePolicy, op: UpdateOp, *, m: int, n: int, rank: int | None = None,
                batch: int | None = None, dtype=torch.float64, device="cuda"):
    """Ready every engine geometry ``op``'s schedule will dispatch (appends
    shift the geometry mid-schedule; each distinct one is warmed) and every
    sketch the schedule's extractions run (``sketch.warmup_sketch``), on
    ``device``.  Returns the list of ``(m, n)`` geometries warmed, as the
    reference's does.

    >>> from repro_torch.updates.ops import AppendRows, Compose, Decay
    >>> op = Compose((Decay(0.9), AppendRows(np.zeros((2, 6)))))
    >>> warmup_plan(UpdatePolicy(method="direct"), op, m=4, n=6, rank=2, device="cpu")
    [(6, 6)]
    """
    r = rank if rank is not None else m
    spec = op.spec()
    oversample, power_iters = _sketch_params(policy)
    for sm, sn, sk, snnz in _sketch_sites(spec, m, n)[0]:
        warmup_sketch(m=sm, n=sn, k=sk, nnz=snnz, batch=batch, oversample=oversample,
                      power_iters=power_iters, dtype=dtype, device=device)
    steps, _ = _build(spec, m, n, r, rank is None, ())
    geoms: list[tuple[int, int]] = []
    entries: dict[tuple[int, int, int | None], UpdatePolicy | None] = {}
    cur_m, cur_n = m, n
    for step in steps:
        if step[0] == "pad_rows":
            cur_m += step[1]
        elif step[0] == "pad_cols":
            cur_n += step[1]
        elif step[0] == "drop_rows":
            cur_m -= len(step[1])
        elif step[0] == "drop_cols":
            cur_n -= len(step[1])
        elif step[0] in ("rank1", "rank1_scan"):
            k = step[3] if step[0] == "rank1_scan" else None
            # remove steps run under the step-pinned policy (_step_policy):
            # warm the route they will actually dispatch
            entries.setdefault((cur_m, cur_n, k), _step_policy(policy, step))
            if (cur_m, cur_n) not in geoms:
                geoms.append((cur_m, cur_n))
    for (gm, gn, k), pol in entries.items():
        warmup(pol, m=gm, n=gn, batch=batch, rank=rank, k=k, dtype=dtype, device=device)
    return geoms
