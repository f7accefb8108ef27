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
``sparse_project_cuda`` sorts the entries stably by destination row
(``sparse_project_prep``) and launches kernel F (``csrc/sparse_proj.cu``), one
group of lanes per destination row, no atomics.  ``sparse_project`` picks by
device: CPU tensors take the plain version, CUDA tensors the kernel, which
raises on what it does not take.  Coordinates are int32; their range is not
checked on the hot path (``check_coords`` does it, on the host, for tests).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "check_coords",
    "cuda_operands",
    "sparse_project",
    "sparse_project_cuda",
    "sparse_project_launch",
    "sparse_project_plain",
    "sparse_project_prep",
]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
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


def _operands(rows, cols, vals, mat) -> _Operands:
    if not isinstance(mat, torch.Tensor):
        mat = torch.as_tensor(np.asarray(mat))
    if not isinstance(vals, torch.Tensor):
        vals = torch.as_tensor(np.asarray(vals), device=mat.device)
    rows, cols = (x if isinstance(x, torch.Tensor)
                  else torch.as_tensor(np.asarray(x), device=vals.device) for x in (rows, cols))
    if vals.dtype != mat.dtype:
        raise ValueError(f"vals and mat must share a dtype; got {vals.dtype} and {mat.dtype}")
    nnz = vals.shape[-1]
    if rows.shape[-1] != nnz or cols.shape[-1] != nnz:
        raise ValueError(f"rows/cols/vals must carry nnz entries on their last axis; got "
                         f"{tuple(rows.shape)}, {tuple(cols.shape)}, {tuple(vals.shape)}")
    lead = tuple(torch.broadcast_shapes(vals.shape[:-1], mat.shape[:-2]))
    for name, x in (("rows", rows), ("cols", cols)):
        if tuple(torch.broadcast_shapes(lead, x.shape[:-1])) != lead:
            raise ValueError(f"{name} {tuple(x.shape)} does not broadcast to the batch {lead}")
    batch = math.prod(lead)

    def flat(x, tail):
        if math.prod(x.shape[:x.dim() - len(tail)]) == 1:
            return x.reshape((1,) + tail)
        return x.expand(lead + tail).reshape((batch,) + tail)

    return _Operands(lead, batch, flat(rows, (nnz,)), flat(cols, (nnz,)), flat(vals, (nnz,)),
                     flat(mat, tuple(mat.shape[-2:])))


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
    """The entries of each batch member sorted stably by destination row:
    ``perm`` (Bc, nnz) int32 and row pointers ``rowptr`` (Bc, out_rows + 1)
    int32, so that row r's entries are ``perm[b, rowptr[b, r]:rowptr[b, r+1]]``
    in their original order.  No atomics and no host synchronisation."""
    sorted_rows, perm = torch.sort(rows, dim=-1, stable=True)
    bounds = torch.arange(out_rows + 1, dtype=rows.dtype, device=rows.device)
    rowptr = torch.searchsorted(sorted_rows, bounds.expand(rows.shape[0], -1).contiguous(),
                                out_int32=True)
    return perm.to(torch.int32), rowptr


def _lane_group(k: int) -> int:
    """Lanes per destination row: the smallest of 8, 16, 32 that covers k."""
    return 8 if k <= 8 else 16 if k <= 16 else 32


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
        if not x.is_cuda or x.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: expected CUDA integer coordinates; got {x.dtype} "
                             f"on {x.device}")
    if op.rows.shape[0] != op.cols.shape[0]:
        # one batched and one shared: give both the batch
        op = op._replace(rows=op.rows.expand(op.batch, -1), cols=op.cols.expand(op.batch, -1))
    if op.batch > _MAX_GRID_Y:
        raise ValueError(f"batch {op.batch} exceeds the kernel's {_MAX_GRID_Y}")
    return op._replace(rows=op.rows.to(torch.int32).contiguous(),
                       cols=op.cols.to(torch.int32).contiguous(),
                       vals=op.vals.contiguous(), mat=op.mat.contiguous())


def sparse_project_launch(perm, rowptr, op: _Operands, out_rows: int) -> torch.Tensor:
    """Kernel F alone, on operands prepared by ``cuda_operands`` and the
    permutation of ``sparse_project_prep``: (B, out_rows, k)."""
    dt = op.mat.dtype
    k = op.mat.shape[-1]
    nnz = op.vals.shape[-1]
    out = torch.empty((op.batch, out_rows, k), dtype=dt, device=op.mat.device)
    if out.numel() == 0:
        return out
    shared = lambda x: x.shape[0] == 1 and op.batch > 1  # noqa: E731
    group = _lane_group(k)
    fn = getattr(_build.library("sparse_proj"), f"sparse_project_{_SUFFIX[dt]}")
    _build.LAUNCHES["sparse_project"] += 1
    _build.check(fn(*_build.ptrs(perm, rowptr, op.cols, op.vals, op.mat, out), op.batch,
                    out_rows, k, group, 0 if shared(op.cols) else nnz,
                    0 if shared(rowptr) else out_rows + 1, 0 if shared(op.vals) else nnz,
                    0 if shared(op.mat) else op.mat.shape[-2] * k, _build.stream()),
                 "sparse_project")
    return out


def sparse_project_cuda(rows, cols, vals, mat, out_rows: int) -> torch.Tensor:
    """Kernel F with its index preparation, on CUDA tensors (f32 or f64)."""
    op = cuda_operands(rows, cols, vals, mat)
    perm, rowptr = sparse_project_prep(op.rows, out_rows)
    out = sparse_project_launch(perm, rowptr, op, out_rows)
    return out.reshape(op.lead + (out_rows, op.mat.shape[-1]))


def sparse_project(rows, cols, vals, mat, out_rows: int) -> torch.Tensor:
    """``out = S @ mat`` for the COO ``S``: the plain version for CPU tensors,
    kernel F when ``vals`` or ``mat`` lies on a card."""
    on_card = any(isinstance(x, torch.Tensor) and x.is_cuda for x in (vals, mat))
    if on_card:
        return sparse_project_cuda(rows, cols, vals, mat, out_rows)
    return sparse_project_plain(rows, cols, vals, mat, out_rows)
