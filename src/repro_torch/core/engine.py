"""Batch-first SVD-update engine, plain PyTorch.

Counterpart of ``repro.core.engine``.  PyTorch runs eagerly, so there is no
executable to cache: the engine keeps the reference's geometry-keyed cache
accounting (``cache_info``: hits, misses, entries as plain integers, mirrored
into the ``engine_plan_cache_hits`` / ``_misses`` counters when observability
is on) and runs Algorithm 6.1 over a leading batch dimension.  ``warmup``
fills that cache for a geometry and builds the CUDA libraries the route will
launch (``kernels._build.library``), so that the first call under traffic
compiles nothing.  Single updates add and remove
that dimension.  The rank-k entry points (the reference's ``lax.scan`` of k
rank-1 updates) are a Python loop of k calls to the same rank-1 body.  Mesh
dispatch is not ported (ROADMAP A7).

Float32 matrix products run in full float32: each call sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")`` (or the policy's precision)
and restores the previous settings afterwards.  This is the counterpart of
the reference's ``SvdEngine._with_precision``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import NamedTuple

import torch

from repro_torch import obs as _obs
from repro_torch.core.svd_update import (
    SvdUpdateResult,
    TruncatedSvd,
    _svd_update_impl,
    _svd_update_truncated_impl,
)

__all__ = [
    "EngineCacheInfo",
    "SvdEngine",
    "default_engine",
    "group_indices",
    "stack_trees",
    "truncated_geometry",
    "unstack_tree",
]

# torch's float32 matmul precisions; None is "highest" (no TF32)
_PRECISION = {None: "highest", "highest": "highest", "high": "high", "medium": "medium"}


def truncated_geometry(tsvd) -> tuple:
    """Batching-group key of a truncated state, ``(m, n, rank, dtype)``: states
    sharing it (on one device) stack into one ``update_truncated_batch``."""
    m, r = tsvd.u.shape
    return (m, tsvd.v.shape[0], r, tsvd.u.dtype)


def group_indices(keys) -> dict:
    """``{key: [indices with that key]}`` in first-seen order."""
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


def _stack(xs):
    return None if any(x is None for x in xs) else torch.stack(xs)


def stack_trees(trees):
    """Stack identically shaped states (dataclasses or tuples of tensors) on a
    new leading batch dimension; a field that is ``None`` anywhere stays ``None``."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: _stack([getattr(t, f.name) for t in trees])
                              for f in dataclasses.fields(first)})
    return type(first)(*(_stack(xs) for xs in zip(*trees)))


def unstack_tree(tree, i: int):
    """Batch element ``i`` of a stacked state (dataclass or tuple of tensors)."""
    pick = lambda x: None if x is None else x[i]  # noqa: E731
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: pick(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return type(tree)(*(pick(x) for x in tree))


class EngineCacheInfo(NamedTuple):
    hits: int
    misses: int
    entries: int


def _geometry(kind: str, *tensors) -> tuple:
    return (kind,) + tuple((tuple(t.shape), t.dtype) for t in tensors)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh-sharded updates are not ported yet (ROADMAP A7)")


class SvdEngine:
    """Rank-1 SVD update engine for one (method, fmm_p, sign_fix, deflate_rtol,
    precision, storage_dtype) configuration."""

    def __init__(self, *, method: str = "direct", fmm_p: int = 20, sign_fix: bool = True,
                 deflate_rtol: float | None = None, precision: str | None = None,
                 storage_dtype: torch.dtype | None = None):
        if method not in ("direct", "fmm", "kernel", "fused"):
            raise ValueError(f"unknown method {method!r}")
        if precision not in _PRECISION:
            raise ValueError(f"unknown precision {precision!r}; one of {tuple(_PRECISION)}")
        self.method = method
        self.fmm_p = fmm_p
        self.sign_fix = sign_fix
        self.deflate_rtol = deflate_rtol
        self.precision = precision
        self.storage_dtype = storage_dtype
        self.compute_dtype = (torch.float32 if storage_dtype is not None
                              and storage_dtype.itemsize <= 2 else None)
        self._geometries: set = set()
        self._built: set = set()     # (geometry key, device type) warmed
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()

    def cache_info(self) -> EngineCacheInfo:
        return EngineCacheInfo(self._hits, self._misses, len(self._geometries))

    def cache_clear(self) -> None:
        with self._lock:
            self._geometries.clear()
            self._built.clear()
            self._hits = 0
            self._misses = 0

    def _count(self, key: tuple) -> None:
        with self._lock:
            hit = key in self._geometries
            if hit:
                self._hits += 1
            else:
                self._misses += 1
                self._geometries.add(key)
        if _obs.enabled():
            _obs.registry().counter(
                "engine_plan_cache_hits" if hit else "engine_plan_cache_misses").inc()

    @contextlib.contextmanager
    def _precision(self):
        prev_tf32 = torch.backends.cuda.matmul.allow_tf32
        prev_prec = torch.get_float32_matmul_precision()
        prec = _PRECISION[self.precision]
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = prec != "highest"
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev_prec)
            torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    def _full(self, u, s, v, a, b) -> SvdUpdateResult:
        with self._precision():
            return _svd_update_impl(u, s, v, a, b, method=self.method, fmm_p=self.fmm_p,
                                    sign_fix=self.sign_fix, deflate_rtol=self.deflate_rtol,
                                    compute_dtype=self.compute_dtype)

    def _trunc(self, t: TruncatedSvd, a, b) -> TruncatedSvd:
        with self._precision():
            return _svd_update_truncated_impl(t, a, b, method=self.method, fmm_p=self.fmm_p,
                                              deflate_rtol=self.deflate_rtol,
                                              compute_dtype=self.compute_dtype)

    def _full_k(self, u, s, v, va, vb) -> SvdUpdateResult:
        """k sequential full updates over a leading batch dimension: ``va``
        (B, k, m), ``vb`` (B, k, n); diagnostics are the last step's."""
        res = SvdUpdateResult(u, s, v, None, None)
        for i in range(va.shape[1]):
            res = self._full(res.u, res.s, res.v, va[:, i], vb[:, i])
        return res

    def _trunc_k(self, t: TruncatedSvd, va, vb) -> TruncatedSvd:
        for i in range(va.shape[1]):
            t = self._trunc(t, va[:, i], vb[:, i])
        return t

    def update(self, u, s, v, a, b) -> SvdUpdateResult:
        """One Algorithm-6.1 update: ``u`` (m, m), ``s`` (m,), ``v`` (n, n)."""
        self._count(_geometry("single", u, s, v, a, b))
        out = self._full(u[None], s[None], v[None], a[None], b[None])
        return SvdUpdateResult(*(x[0] for x in out))

    def update_batch(self, u, s, v, a, b, *, mesh=None) -> SvdUpdateResult:
        """B stacked updates: ``u`` (B, m, m), ``s`` (B, m), ``v`` (B, n, n),
        ``a`` (B, m), ``b`` (B, n)."""
        _no_mesh(mesh)
        if u.dim() != 3:
            raise ValueError(f"update_batch expects stacked (B, m, m) u; got {tuple(u.shape)}")
        self._count(_geometry("batch", u, s, v, a, b))
        return self._full(u, s, v, a, b)

    def update_truncated(self, tsvd, a, b) -> TruncatedSvd:
        """One Brand-truncated update: ``u`` (m, r), ``s`` (r,), ``v`` (n, r)."""
        self._count(_geometry("trunc", tsvd.u, tsvd.s, tsvd.v, a, b))
        out = self._trunc(TruncatedSvd(tsvd.u[None], tsvd.s[None], tsvd.v[None]),
                          a[None], b[None])
        return TruncatedSvd(*(x[0] for x in out))

    def update_truncated_batch(self, tsvd, a, b, *, mesh=None) -> TruncatedSvd:
        """B stacked truncated updates: ``u`` (B, m, r), ``s`` (B, r), ``v`` (B, n, r)."""
        _no_mesh(mesh)
        if tsvd.u.dim() != 3:
            raise ValueError(f"update_truncated_batch expects stacked (B, m, r) u; "
                             f"got {tuple(tsvd.u.shape)}")
        self._count(_geometry("trunc_batch", tsvd.u, tsvd.s, tsvd.v, a, b))
        return self._trunc(TruncatedSvd(tsvd.u, tsvd.s, tsvd.v), a, b)

    # -- rank-k entry points: k rank-1 pairs applied in row order ------------

    def update_rank_k(self, u, s, v, va, vb) -> SvdUpdateResult:
        """k sequential full updates: ``va`` (k, m), ``vb`` (k, n);
        ``d_left``/``d_right`` are the last step's."""
        self._count(_geometry("rank_k", u, s, v, va, vb))
        out = self._full_k(u[None], s[None], v[None], va[None], vb[None])
        return SvdUpdateResult(*(None if x is None else x[0] for x in out))

    def update_rank_k_batch(self, u, s, v, va, vb, *, mesh=None) -> SvdUpdateResult:
        """B stacked k-step updates: ``u`` (B, m, m), ``va`` (B, k, m), ..."""
        _no_mesh(mesh)
        if u.dim() != 3:
            raise ValueError(f"update_rank_k_batch expects stacked (B, m, m) u; "
                             f"got {tuple(u.shape)}")
        self._count(_geometry("rank_k_batch", u, s, v, va, vb))
        return self._full_k(u, s, v, va, vb)

    def update_truncated_rank_k(self, tsvd, va, vb) -> TruncatedSvd:
        """k sequential truncated updates: ``va`` (k, m), ``vb`` (k, n)."""
        self._count(_geometry("trunc_rank_k", tsvd.u, tsvd.s, tsvd.v, va, vb))
        out = self._trunc_k(TruncatedSvd(tsvd.u[None], tsvd.s[None], tsvd.v[None]),
                            va[None], vb[None])
        return TruncatedSvd(*(x[0] for x in out))

    def update_truncated_rank_k_batch(self, tsvd, va, vb, *, mesh=None) -> TruncatedSvd:
        """B stacked k-step truncated updates: ``va`` (B, k, m), ``vb`` (B, k, n)."""
        _no_mesh(mesh)
        if tsvd.u.dim() != 3:
            raise ValueError(f"update_truncated_rank_k_batch expects stacked (B, m, r) u; "
                             f"got {tuple(tsvd.u.shape)}")
        self._count(_geometry("trunc_rank_k_batch", tsvd.u, tsvd.s, tsvd.v, va, vb))
        return self._trunc_k(TruncatedSvd(tsvd.u, tsvd.s, tsvd.v), va, vb)


    # -- warmup ---------------------------------------------------------------

    def warmup(self, *, batch: int | None, m: int, n: int, rank: int | None = None,
               k: int | None = None, dtype=torch.float32, device="cuda") -> EngineCacheInfo:
        """Warm one geometry before traffic: its entry in the geometry cache
        (counted as the reference counts its AOT compile: one miss, then
        hits), and, on a CUDA device, the libraries of the kernels the route
        launches, built and loaded, with the fused kernels' launch plan for
        the batch.  ``rank=None`` warms the full update, else the truncated
        one; ``batch=None`` the single form; ``k`` the rank-k form.  The key
        includes ``dtype``: warm with the dtype real traffic stores.  Returns
        ``cache_info()``."""
        from repro_torch.api.policy import as_torch_dtype
        from repro_torch.api.state import resolve_device

        dev = resolve_device(device)
        dt = as_torch_dtype(dtype)
        lead = () if batch is None else (batch,)
        pair = ((m,), (n,)) if k is None else ((k, m), (k, n))
        if rank is None:
            leaves = ((m, m), (m,), (n, n))
            kind = ("single", "batch", "rank_k", "rank_k_batch")[(batch is not None) + 2 * (k is not None)]
        else:
            leaves = ((m, rank), (rank,), (n, rank))
            kind = ("trunc", "trunc_batch", "trunc_rank_k",
                    "trunc_rank_k_batch")[(batch is not None) + 2 * (k is not None)]
        key = (kind,) + tuple((lead + shp, dt) for shp in leaves + pair)
        self._count(key)
        if (key, dev.type) not in self._built:
            span_kw = {} if rank is None else {"rank": rank}
            with _obs.span("aot_warmup", kind=kind, batch=batch or 0, m=m, n=n, **span_kw,
                           k=k or 0):
                if dev.type == "cuda":
                    self._build_route(batch or 1, m, n, rank, dt)
            with self._lock:
                self._built.add((key, dev.type))
        return self.cache_info()

    def _build_route(self, bsz: int, m: int, n: int, rank: int | None, dt: torch.dtype) -> None:
        """Build and load the libraries of the kernels this engine's route
        launches for the geometry (the phase chain launches none)."""
        from repro_torch.kernels import _build
        from repro_torch.kernels import fused_update as FU

        if self.method == "fused":
            cdt = self.compute_dtype if self.compute_dtype is not None else FU._compute_dtype_for(dt)
            suffix = FU._SUFFIX[(dt, cdt)]
            _build.library(f"fused_update_{suffix}")
            FU.launch_plan(suffix, bsz, m, n, rank)
        elif self.method == "kernel":
            _build.library("cauchy_matmul")
        elif self.method == "fmm":
            _build.library("nearfield")


_default_engines: dict[tuple, SvdEngine] = {}
_default_lock = threading.Lock()


def default_engine(method: str = "direct", *, fmm_p: int = 20, sign_fix: bool = True,
                   deflate_rtol: float | None = None, precision: str | None = None,
                   storage_dtype: torch.dtype | None = None) -> SvdEngine:
    """The process-wide engine for a configuration (shared cache accounting)."""
    key = (method, fmm_p, sign_fix, deflate_rtol, precision, storage_dtype)
    with _default_lock:
        eng = _default_engines.get(key)
        if eng is None:
            eng = SvdEngine(method=method, fmm_p=fmm_p, sign_fix=sign_fix,
                            deflate_rtol=deflate_rtol, precision=precision,
                            storage_dtype=storage_dtype)
            _default_engines[key] = eng
        return eng

