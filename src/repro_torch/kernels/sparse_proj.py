"""COO sparse projection: the ``Sparse`` op's only contact with the matrix.

Counterpart of ``repro.kernels.sparse_proj``.  For a static-nnz COO matrix
``S[rows[e], cols[e]] += vals[e]`` and a dense ``(src, k)`` block ``mat``:

    out[rows[e], :] += vals[e] * mat[cols[e], :]        for every entry e

i.e. ``out = S @ mat`` (swap ``rows``/``cols`` for ``S^T @ mat``).
Duplicate coordinates accumulate; padding entries (0, 0, 0.0) add zero.

Broadcasting follows the reference: ``vals`` (…, nnz) and ``mat``
(…, src, k) define the leading batch shape, and ``rows``/``cols`` (…, nnz)
broadcast up to it (one COO pattern shared by a batch of values is the
common case).  The reference's ``custom_vmap`` rule collapses into that
explicit batch.

``sparse_project_plain`` is the plain PyTorch version, a segment sum with
``index_add_`` in entry order (the counterpart of ``sparse_project_xla``).
``sparse_project_cuda`` launches kernel F (``csrc/sparse_proj.cu``) in one
call: the bucketing of the entries by destination row, in entry order, on the
card, then one group of lanes per destination row, no atomics on values.
``sparse_project_prep`` is the plain PyTorch version of that bucketing (a
stable sort and ``searchsorted``); ``sparse_bucket_cuda`` and
``sparse_project_launch`` run the kernel's two halves apart, for tests and
timings.  ``sparse_project`` picks by device: CPU tensors take the plain
version, CUDA tensors the kernel, which raises on what it does not take.
Coordinates are int32; their range is not checked on the hot path (the
kernel drops an entry out of range; ``check_coords`` raises on one, on the
host, for tests).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "check_coords",
    "cuda_operands",
    "sparse_bucket_cuda",
    "sparse_project",
    "sparse_project_cuda",
    "sparse_project_launch",
    "sparse_project_plain",
    "sparse_project_prep",
]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_COORDS = (torch.int32, torch.int64)
_MAX_GRID_Y = 65535


class _Operands(NamedTuple):
    """Operands with one flat batch dimension each, of size 1 (shared by the
    whole batch) or ``batch``; ``lead`` is the caller's batch shape."""

    lead: tuple
    batch: int
    rows: torch.Tensor  # (1 or B, nnz)
    cols: torch.Tensor  # (1 or B, nnz)
    vals: torch.Tensor  # (1 or B, nnz)
    mat: torch.Tensor   # (1 or B, src, k)


def _broadcast(a: tuple, b: tuple) -> tuple:
    if a == b or not b:
        return a
    if not a:
        return b
    return tuple(torch.broadcast_shapes(a, b))


def _flat(x, lead: tuple, batch: int, tail: int):
    """``x`` with one flat batch dimension: (1, …) when the whole batch
    shares it, else (batch, …); a view unless a partial broadcast forces a
    copy."""
    head = x.shape[:x.dim() - tail]
    if len(head) == 1 and head[0] in (1, batch):
        return x
    if math.prod(head) == 1:
        return x.reshape((1,) + tuple(x.shape[x.dim() - tail:]))
    return x.expand(tuple(lead) + tuple(x.shape[x.dim() - tail:])).reshape(
        (batch,) + tuple(x.shape[x.dim() - tail:]))


def _operands(rows, cols, vals, mat) -> _Operands:
    if not isinstance(mat, torch.Tensor):
        mat = torch.as_tensor(np.asarray(mat))
    if not isinstance(vals, torch.Tensor):
        vals = torch.as_tensor(np.asarray(vals), device=mat.device)
    if not isinstance(rows, torch.Tensor):
        rows = torch.as_tensor(np.asarray(rows), device=vals.device)
    if not isinstance(cols, torch.Tensor):
        cols = torch.as_tensor(np.asarray(cols), device=vals.device)
    if vals.dtype != mat.dtype:
        raise ValueError(f"vals and mat must share a dtype; got {vals.dtype} and {mat.dtype}")
    nnz = vals.shape[-1]
    if rows.shape[-1] != nnz or cols.shape[-1] != nnz:
        raise ValueError(f"rows/cols/vals must carry nnz entries on their last axis; got "
                         f"{tuple(rows.shape)}, {tuple(cols.shape)}, {tuple(vals.shape)}")
    lead = _broadcast(vals.shape[:-1], mat.shape[:-2])
    for name, x in (("rows", rows), ("cols", cols)):
        if _broadcast(lead, x.shape[:-1]) != lead:
            raise ValueError(f"{name} {tuple(x.shape)} does not broadcast to the batch {tuple(lead)}")
    batch = math.prod(lead)
    return _Operands(lead, batch, _flat(rows, lead, batch, 1), _flat(cols, lead, batch, 1),
                     _flat(vals, lead, batch, 1), _flat(mat, lead, batch, 2))


def check_coords(rows, cols, out_rows: int, src_rows: int) -> None:
    """Raise unless every coordinate lies in range: ``0 <= rows < out_rows``
    and ``0 <= cols < src_rows`` (a host check, for tests: it synchronises)."""
    for name, x, hi in (("rows", rows, out_rows), ("cols", cols, src_rows)):
        x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if x.numel() and (int(x.min()) < 0 or int(x.max()) >= hi):
            raise ValueError(f"{name} out of range [0, {hi}): min {int(x.min())}, "
                             f"max {int(x.max())}")


def sparse_project_plain(rows, cols, vals, mat, out_rows: int) -> torch.Tensor:
    """The plain version: gather and scale the source rows, then one segment
    sum (``index_add_``) into the destination rows, in entry order."""
    op = _operands(rows, cols, vals, mat)
    bsz, (nnz, (src, k)) = op.batch, (op.vals.shape[-1], op.mat.shape[-2:])
    cols_b = op.cols.long().expand(bsz, nnz)
    gathered = op.mat.expand(bsz, src, k).gather(1, cols_b[..., None].expand(bsz, nnz, k))
    gathered = op.vals.expand(bsz, nnz)[..., None] * gathered
    dest = op.rows.long() + torch.arange(bsz, device=op.rows.device)[:, None] * out_rows
    out = torch.zeros((bsz * out_rows, k), dtype=op.mat.dtype, device=op.mat.device)
    out.index_add_(0, dest.reshape(-1), gathered.reshape(bsz * nnz, k))
    return out.reshape(op.lead + (out_rows, k))


def sparse_project_prep(rows, out_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel F's bucketing: the entries of each batch
    member sorted stably by destination row, ``perm`` (Bc, nnz) int32 and row
    pointers ``rowptr`` (Bc, out_rows + 1) int32, so that row r's entries are
    ``perm[b, rowptr[b, r]:rowptr[b, r+1]]`` in their original order."""
    sorted_rows, perm = torch.sort(rows, dim=-1, stable=True)
    bounds = torch.arange(out_rows + 1, dtype=rows.dtype, device=rows.device)
    rowptr = torch.searchsorted(sorted_rows, bounds.expand(rows.shape[0], -1).contiguous(),
                                out_int32=True)
    return perm.to(torch.int32), rowptr


def _int32(x):
    return (x if x.dtype == torch.int32 else x.to(torch.int32)).contiguous()


def cuda_operands(rows, cols, vals, mat) -> _Operands:
    """The operands as kernel F takes them, checked: int32 coordinates, one
    flat batch dimension each (shared ones of size 1), contiguous."""
    op = _operands(rows, cols, vals, mat)
    dt = op.mat.dtype
    if dt not in _SUFFIX:
        raise NotImplementedError(f"the sparse-projection kernel takes f32 or f64; got {dt}")
    for name, x in (("vals", op.vals), ("mat", op.mat)):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor; got one on {x.device}")
    for name, x in (("rows", op.rows), ("cols", op.cols)):
        if not x.is_cuda or x.dtype not in _COORDS:
            raise ValueError(f"{name}: expected CUDA integer coordinates; got {x.dtype} "
                             f"on {x.device}")
    if op.batch > _MAX_GRID_Y:
        raise ValueError(f"batch {op.batch} exceeds the kernel's {_MAX_GRID_Y}")
    return op._replace(rows=_int32(op.rows), cols=_int32(op.cols), vals=op.vals.contiguous(),
                       mat=op.mat.contiguous())


# batch flags of csrc/sparse_proj.cu's entry points
_ROWS, _COLS, _VALS, _MAT, _WALK = 1, 2, 4, 8, 16


def _flags(op: _Operands) -> int:
    """Which operands carry a member per batch member (the others the batch
    shares, read at stride 0)."""
    r, c, v, m = op.rows, op.cols, op.vals, op.mat
    return ((r.dim() > 1 and r.shape[0] > 1) * _ROWS | (c.dim() > 1 and c.shape[0] > 1) * _COLS
            | (v.dim() > 1 and v.shape[0] > 1) * _VALS | (m.dim() > 2 and m.shape[0] > 1) * _MAT)


_ENTRY_POINTS: dict = {}


def _entry(name: str):
    """The library's entry point ``name``, looked up once."""
    fn = _ENTRY_POINTS.get(name)
    if fn is None:
        fn = _ENTRY_POINTS[name] = getattr(_build.library("sparse_proj"), name)
    return fn


@functools.lru_cache(maxsize=256)
def _scratch_ints(members: int, nnz: int, out_rows: int, walk: bool) -> int:
    return _entry("sparse_scratch_ints")(members, nnz, out_rows, walk)


def _card_operands(rows, cols, vals, mat) -> _Operands:
    """``cuda_operands`` without the flattening views when every operand
    already has a batch axis of its own of 1 or B, or none (the sketch's
    calls): on the hot path each view costs microseconds of host time."""
    if not (isinstance(rows, torch.Tensor) and isinstance(cols, torch.Tensor)
            and isinstance(vals, torch.Tensor) and isinstance(mat, torch.Tensor)):
        return cuda_operands(rows, cols, vals, mat)
    rd, cd, vd, md = rows.dim(), cols.dim(), vals.dim(), mat.dim()
    nnz = vals.shape[-1]
    batch = max(vals.shape[0] if vd == 2 else 1, mat.shape[0] if md == 3 else 1)
    if not (rd <= 2 and cd <= 2 and vd <= 2 and 2 <= md <= 3
            and all(x.shape[0] in (1, batch) for x, d in ((rows, rd), (cols, cd), (vals, vd))
                    if d == 2) and (md == 2 or mat.shape[0] in (1, batch))
            and rows.shape[-1] == nnz and cols.shape[-1] == nnz and vals.dtype == mat.dtype
            and mat.dtype in _SUFFIX and vals.is_cuda and mat.is_cuda and rows.is_cuda
            and cols.is_cuda and rows.dtype in _COORDS and cols.dtype in _COORDS
            and batch <= _MAX_GRID_Y):
        return cuda_operands(rows, cols, vals, mat)   # broadcasts, or raises with the reason
    return _Operands((batch,) if vd == 2 or md == 3 else (), batch, _int32(rows), _int32(cols),
                     vals.contiguous(), mat.contiguous())


def _project(op: _Operands, out_rows: int, walk: bool):
    """Launch the bucketing (and the walk): ``(out, scratch, members)``."""
    dt = op.mat.dtype
    src, k = op.mat.shape[-2:]
    nnz = op.vals.shape[-1]
    flags = _flags(op)
    members = op.batch if flags & _ROWS else 1
    if members * max(nnz, out_rows + 1) >= 2 ** 31:
        raise ValueError(f"{members} x {nnz} entries or {out_rows} rows exceed int32 positions")
    out = torch.empty((op.batch, out_rows, k) if walk else (0,), dtype=dt, device=op.mat.device)
    n_scratch = _scratch_ints(members, nnz, out_rows, walk)
    scratch = (torch.empty(n_scratch, dtype=torch.int32, device=op.mat.device) if n_scratch
               else None)
    fn = _entry(f"sparse_project_{_SUFFIX[dt]}")
    _build.LAUNCHES["sparse_project"] += 1
    _build.check(fn(op.rows.data_ptr(), op.cols.data_ptr(), op.vals.data_ptr(), op.mat.data_ptr(),
                    out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), op.batch, nnz,
                    out_rows, src, k, flags | (_WALK if walk else 0), _build.stream()),
                 "sparse_project")
    return out, scratch, members


def sparse_bucket_cuda(rows, out_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel F's bucketing alone, on the card: ``rows`` (Bc, nnz) int32 CUDA,
    every row in range -> ``(perm, rowptr)`` as ``sparse_project_prep`` gives
    them."""
    members, nnz = rows.shape
    rows = _int32(rows)
    dummy = torch.empty((1, 1, 1), dtype=torch.float64, device=rows.device)
    _, scratch, _ = _project(_Operands((members,), members, rows, rows, dummy[0].expand(1, nnz),
                                       dummy), out_rows, walk=False)
    slots = members * (out_rows + 1)     # the scratch starts with rowptr, then perm
    rowptr = scratch[:slots].view(members, out_rows + 1)
    perm = scratch[slots:slots + members * nnz].view(members, nnz)
    first = torch.arange(members, device=rows.device, dtype=torch.int32)[:, None] * nnz
    return perm - first, rowptr - rowptr[:, :1]


def sparse_project_launch(perm, rowptr, op: _Operands, out_rows: int) -> torch.Tensor:
    """Kernel F's walk alone, on operands prepared by ``cuda_operands`` and a
    bucketing ``(perm, rowptr)`` laid out as ``sparse_project_prep`` gives it
    ((1 or B, nnz) and (1 or B, out_rows + 1), contiguous): (B, out_rows, k)."""
    dt = op.mat.dtype
    src, k = op.mat.shape[-2:]
    nnz = op.vals.shape[-1]
    out = torch.empty((op.batch, out_rows, k), dtype=dt, device=op.mat.device)
    if out.numel() == 0:
        return out
    flags = (_flags(op) & ~_ROWS) | (_ROWS if perm.shape[0] > 1 else 0)
    fn = _entry(f"sparse_walk_{_SUFFIX[dt]}")
    _build.LAUNCHES["sparse_project"] += 1
    _build.check(fn(perm.contiguous().data_ptr(), rowptr.contiguous().data_ptr(),
                    op.cols.data_ptr(), op.vals.data_ptr(), op.mat.data_ptr(), out.data_ptr(),
                    op.batch, nnz, out_rows, src, k, flags, _build.stream()), "sparse_project")
    return out


def sparse_project_cuda(rows, cols, vals, mat, out_rows: int) -> torch.Tensor:
    """Kernel F on CUDA tensors (f32 or f64): the bucketing and the walk in
    one call."""
    op = _card_operands(rows, cols, vals, mat)
    k = op.mat.shape[-1]
    if op.batch * out_rows * k == 0:
        return torch.empty(tuple(op.lead) + (out_rows, k), dtype=op.mat.dtype, device=op.mat.device)
    out = _project(op, out_rows, walk=True)[0]
    return out if len(op.lead) == 1 else out.reshape(tuple(op.lead) + (out_rows, k))


def sparse_project(rows, cols, vals, mat, out_rows: int) -> torch.Tensor:
    """``out = S @ mat`` for the COO ``S``: the plain version for CPU tensors,
    kernel F when ``vals`` or ``mat`` lies on a card."""
    if ((isinstance(vals, torch.Tensor) and vals.is_cuda)
            or (isinstance(mat, torch.Tensor) and mat.is_cuda)):
        return sparse_project_cuda(rows, cols, vals, mat, out_rows)
    return sparse_project_plain(rows, cols, vals, mat, out_rows)
