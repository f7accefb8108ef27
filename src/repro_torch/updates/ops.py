"""The structured-perturbation op algebra, in PyTorch.

Counterpart of ``repro.updates.ops``.  Each op is a frozen dataclass with an
exact reference semantics ``op.apply_dense(A)``; ``updates.planner`` lowers
any op onto a schedule of rank-1 updates.

* ``RankK(u, v)``: ``A + u @ v^T`` with ``u (…, m, k)``, ``v (…, n, k)``.
* ``AppendRows(rows)`` / ``AppendCols(cols)``: grow the matrix by new rows
  ``(p, n)`` / columns ``(m, p)``; ``from_svd`` carries a pre-factored block.
* ``DenseDelta(delta, rank)``: ``A + delta`` through a top-``rank`` sketch.
* ``Sparse(rows, cols, vals, rank)``: ``A + S`` for a static-nnz COO delta,
  lowered through ``updates.sketch`` and ``kernels.sparse_proj``.
* ``Decay(lam)``: ``lam * A``, folded into the singular values for free.
* ``RemoveRows(idx)`` / ``RemoveCols(idx)``: delete rows / columns.
* ``Window(size, lam)``: keep the last ``size`` rows, decayed by ``lam``.
* ``Compose(ops)``: apply a tuple of ops left-to-right.

Ops hold tensors or numpy arrays and carry no device of their own: the
planner moves their data to the state's device when it binds a step, and
``apply_dense`` computes where its matrix lives.  ``spec()`` is the hashable
structural descriptor (type and static shapes, no data) that keys the
planner's schedule cache; ``spec_to_json`` / ``spec_from_json`` /
``skeleton_from_spec`` carry it through JSON.

>>> import numpy as np
>>> op = Compose((Decay(0.5), RankK(np.ones((2, 1)), np.ones((3, 1)))))
>>> op.apply_dense(np.ones((2, 3)))
tensor([[1.5000, 1.5000, 1.5000],
        [1.5000, 1.5000, 1.5000]], dtype=torch.float64)
>>> op.spec()
('compose', (('decay',), ('rank_k', 1)))
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any

import numpy as np
import torch

__all__ = [
    "AppendCols",
    "AppendRows",
    "Compose",
    "Decay",
    "DenseDelta",
    "RankK",
    "RemoveCols",
    "RemoveRows",
    "Sparse",
    "UpdateOp",
    "Window",
    "skeleton_from_spec",
    "spec_from_json",
    "spec_to_json",
]


def _tensor(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as a tensor; with ``like``, on its device and in the promoted
    floating dtype of the two."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if like is None:
        return t
    return t.to(device=like.device, dtype=torch.promote_types(t.dtype, like.dtype))


def _matrix(a_mat) -> torch.Tensor:
    t = _tensor(a_mat)
    return t if t.is_floating_point() else t.to(torch.float64)


def _normalize_idx(idx, what: str) -> tuple:
    """Sorted tuple of unique non-negative ints (static metadata: it keys the
    schedule cache)."""
    try:
        idx = (operator.index(idx),)
    except TypeError:
        pass
    try:
        out = tuple(int(i) for i in idx)
    except TypeError:
        raise TypeError(f"{what} takes an int or a sequence of ints; got {idx!r}") from None
    if not out:
        raise ValueError(f"{what} needs at least one index")
    if any(i < 0 for i in out):
        raise ValueError(f"{what} indices must be non-negative; got {out}")
    if len(set(out)) != len(out):
        # duplicates would double-subtract under the rank-1 lowering
        # (zeroing an already-zeroed slice negates instead of removing)
        raise ValueError(f"{what} indices must be unique; got {out}")
    return tuple(sorted(out))


def _delete(a_mat: torch.Tensor, idx: tuple, dim: int) -> torch.Tensor:
    drop = set(idx)
    keep = [i for i in range(a_mat.shape[dim]) if i not in drop]
    return a_mat.index_select(dim, torch.tensor(keep, dtype=torch.long, device=a_mat.device))


class UpdateOp:
    """Base class (isinstance anchor) for structured-perturbation ops.

    ``tree_fields`` names the fields that hold data (``None``: every field),
    in the reference's pytree order: they are the op's leaves in a service
    snapshot (``train.checkpoint``); the other fields are structure."""

    tree_fields = None

    def apply_dense(self, a_mat) -> torch.Tensor:
        """Exact reference semantics on a dense matrix."""
        raise NotImplementedError

    def out_shape(self, m: int, n: int) -> tuple[int, int]:
        """Geometry after the op (appends grow it, removes shrink it)."""
        return (m, n)

    def spec(self) -> tuple:
        """Hashable structural descriptor: the planner's cache key."""
        raise NotImplementedError

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RankK(UpdateOp):
    """``A + u @ v^T``: ``u`` (…, m, k), ``v`` (…, n, k); a leading batch axis
    means one rank-k update per stacked problem.

    >>> import numpy as np
    >>> op = RankK(np.eye(3, 2), np.eye(4, 2))
    >>> op.k, op.spec()
    (2, ('rank_k', 2))
    """

    u: Any
    v: Any

    @property
    def k(self) -> int:
        return self.u.shape[-1]

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        u, v = _tensor(self.u, a_mat), _tensor(self.v, a_mat)
        return a_mat + u @ v.mT

    def spec(self) -> tuple:
        return ("rank_k", self.k)


@dataclasses.dataclass(frozen=True)
class AppendRows(UpdateOp):
    """Grow the matrix by ``p`` new rows: ``[A; rows]``, with dense
    ``rows (p, n)`` or a pre-factored block ``from_svd(u, s, v)``
    (``u (p, q)``, ``s (q,)``, ``v (n, q)``).

    >>> import numpy as np
    >>> AppendRows(np.zeros((2, 5))).out_shape(3, 5)
    (5, 5)
    """

    rows: Any = None
    u: Any = None
    s: Any = None
    v: Any = None

    def __post_init__(self):
        dense = self.rows is not None
        factored = self.u is not None and self.s is not None and self.v is not None
        if dense == factored:
            raise ValueError("AppendRows takes either rows= or from_svd factors")

    @classmethod
    def from_svd(cls, u, s, v) -> "AppendRows":
        return cls(rows=None, u=u, s=s, v=v)

    @property
    def p(self) -> int:
        """Number of appended rows."""
        return self.rows.shape[0] if self.rows is not None else self.u.shape[0]

    @property
    def block_rank(self) -> int:
        """Rank budget of the lowering (q components)."""
        if self.rows is not None:
            return min(self.rows.shape[0], self.rows.shape[1])
        return self.s.shape[0]

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        if self.rows is not None:
            block = _tensor(self.rows, a_mat)
        else:
            u, s, v = (_tensor(x, a_mat) for x in (self.u, self.s, self.v))
            block = (u * s) @ v.mT
        return torch.cat([a_mat.to(block.dtype), block], dim=0)

    def out_shape(self, m: int, n: int) -> tuple[int, int]:
        return (m + self.p, n)

    def spec(self) -> tuple:
        mode = "dense" if self.rows is not None else "factored"
        return ("append_rows", self.p, self.block_rank, mode)


@dataclasses.dataclass(frozen=True)
class AppendCols(UpdateOp):
    """Grow the matrix by ``p`` new columns: ``[A, cols]``; ``from_svd(u, s,
    v)`` carries a pre-factored block (``u (m, q)``, ``s (q,)``, ``v (p, q)``).

    >>> import numpy as np
    >>> AppendCols(np.zeros((3, 2))).out_shape(3, 5)
    (3, 7)
    """

    cols: Any = None
    u: Any = None
    s: Any = None
    v: Any = None

    def __post_init__(self):
        dense = self.cols is not None
        factored = self.u is not None and self.s is not None and self.v is not None
        if dense == factored:
            raise ValueError("AppendCols takes either cols= or from_svd factors")

    @classmethod
    def from_svd(cls, u, s, v) -> "AppendCols":
        return cls(cols=None, u=u, s=s, v=v)

    @property
    def p(self) -> int:
        return self.cols.shape[1] if self.cols is not None else self.v.shape[0]

    @property
    def block_rank(self) -> int:
        if self.cols is not None:
            return min(self.cols.shape[0], self.cols.shape[1])
        return self.s.shape[0]

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        if self.cols is not None:
            block = _tensor(self.cols, a_mat)
        else:
            u, s, v = (_tensor(x, a_mat) for x in (self.u, self.s, self.v))
            block = (u * s) @ v.mT
        return torch.cat([a_mat.to(block.dtype), block], dim=1)

    def out_shape(self, m: int, n: int) -> tuple[int, int]:
        return (m, n + self.p)

    def spec(self) -> tuple:
        mode = "dense" if self.cols is not None else "factored"
        return ("append_cols", self.p, self.block_rank, mode)


@dataclasses.dataclass(frozen=True)
class DenseDelta(UpdateOp):
    """``A + delta`` lowered through a top-``rank`` randomized sketch of
    ``delta`` (``updates.sketch.sketch_svd``); exact when ``rank >=
    rank(delta)``.

    >>> import numpy as np
    >>> DenseDelta(np.ones((3, 4)), rank=1).spec()
    ('dense_delta', 1)
    """

    tree_fields = ("delta",)

    delta: Any
    rank: int = 1

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"sketch rank must be >= 1; got {self.rank}")

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        return a_mat + _tensor(self.delta, a_mat)

    def spec(self) -> tuple:
        return ("dense_delta", self.rank)


@dataclasses.dataclass(frozen=True)
class Sparse(UpdateOp):
    """``A + S`` for a static-nnz COO delta ``S[rows[e], cols[e]] += vals[e]``:
    events that touch a few rows of an embedding matrix.

    ``rows``/``cols``/``vals``: (…, nnz) with a leading batch axis iff one
    delta per stacked problem (coordinates may stay shared under batched
    values).  ``nnz`` keys the schedule cache; streams with varying event
    counts pad with zero-valued entries at (0, 0), which are exact no-ops.
    Duplicate coordinates accumulate.  ``rank`` budgets the lowering
    (``rank >= rank(S)`` is exact).  The planner lowers it through
    ``updates.sketch.sparse_sketch_svd`` and kernel F
    (``kernels.sparse_proj``), never densifying m x n.

    >>> import numpy as np
    >>> op = Sparse(np.array([0, 2]), np.array([1, 0]), np.array([5.0, -1.0]))
    >>> op.nnz, op.spec()
    (2, ('sparse', 2, 1))
    >>> op.apply_dense(np.zeros((3, 2)))
    tensor([[ 0.,  5.],
            [ 0.,  0.],
            [-1.,  0.]], dtype=torch.float64)
    """

    tree_fields = ("rows", "cols", "vals")

    rows: Any
    cols: Any
    vals: Any
    rank: int = 1

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"sketch rank must be >= 1; got {self.rank}")

    @property
    def nnz(self) -> int:
        """Static entry count (padding entries included)."""
        return self.vals.shape[-1]

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        vals = _tensor(self.vals, a_mat)
        rows = _tensor(self.rows).to(device=a_mat.device, dtype=torch.long)
        cols = _tensor(self.cols).to(device=a_mat.device, dtype=torch.long)
        lead = torch.broadcast_shapes(a_mat.shape[:-2], vals.shape[:-1], rows.shape[:-1],
                                      cols.shape[:-1])
        m, n = a_mat.shape[-2:]
        out = a_mat.to(vals.dtype).expand(lead + (m, n)).reshape(-1, m * n).clone()
        nnz = vals.shape[-1]
        flat = (rows * n + cols).expand(lead + (nnz,)).reshape(-1, nnz)
        out.scatter_add_(1, flat, vals.expand(lead + (nnz,)).reshape(-1, nnz))
        return out.reshape(lead + (m, n))

    def spec(self) -> tuple:
        return ("sparse", self.nnz, self.rank)


@dataclasses.dataclass(frozen=True)
class Decay(UpdateOp):
    """Forgetting-factor rescale ``lam * A``, folded into the singular values
    (zero engine dispatches).

    >>> import numpy as np
    >>> Decay(0.5).apply_dense(np.full((1, 2), 4.0))
    tensor([[2., 2.]], dtype=torch.float64)
    """

    lam: Any

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        return _tensor(self.lam, a_mat) * a_mat

    def spec(self) -> tuple:
        return ("decay",)


@dataclasses.dataclass(frozen=True)
class RemoveRows(UpdateOp):
    """Delete rows ``idx`` (static, unique, sorted): each is zeroed by a
    rank-1 update bound from the current factors, then dropped from ``u``.

    >>> import numpy as np
    >>> op = RemoveRows((2, 0))
    >>> op.idx, op.spec(), op.out_shape(4, 3)
    ((0, 2), ('remove_rows', (0, 2)), (2, 3))
    """

    tree_fields = ()

    idx: tuple

    def __post_init__(self):
        object.__setattr__(self, "idx", _normalize_idx(self.idx, "RemoveRows"))

    @property
    def p(self) -> int:
        """Number of removed rows."""
        return len(self.idx)

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        if self.idx[-1] >= a_mat.shape[-2]:
            raise ValueError(f"RemoveRows{self.idx} out of range for {a_mat.shape[-2]} rows")
        return _delete(a_mat, self.idx, a_mat.dim() - 2)

    def out_shape(self, m: int, n: int) -> tuple[int, int]:
        return (m - self.p, n)

    def spec(self) -> tuple:
        return ("remove_rows", self.idx)


@dataclasses.dataclass(frozen=True)
class RemoveCols(UpdateOp):
    """Delete columns ``idx``: each is zeroed by ``A - (A e_j) e_j^T`` on the
    rank-1 engine, then dropped from ``v``.

    >>> op = RemoveCols(1)
    >>> op.idx, op.spec(), op.out_shape(2, 3)
    ((1,), ('remove_cols', (1,)), (2, 2))
    """

    tree_fields = ()

    idx: tuple

    def __post_init__(self):
        object.__setattr__(self, "idx", _normalize_idx(self.idx, "RemoveCols"))

    @property
    def p(self) -> int:
        """Number of removed columns."""
        return len(self.idx)

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        if self.idx[-1] >= a_mat.shape[-1]:
            raise ValueError(f"RemoveCols{self.idx} out of range for {a_mat.shape[-1]} cols")
        return _delete(a_mat, self.idx, a_mat.dim() - 1)

    def out_shape(self, m: int, n: int) -> tuple[int, int]:
        return (m, n - self.p)

    def spec(self) -> tuple:
        return ("remove_cols", self.idx)


@dataclasses.dataclass(frozen=True)
class Window(UpdateOp):
    """Keep the LAST ``size`` rows (the oldest leave first), scaled by
    ``lam``: a decay fold plus one downdate per evicted row.

    >>> op = Window(2)
    >>> op.spec(), op.out_shape(5, 3), op.out_shape(1, 3)
    (('window', 2), (2, 3), (1, 3))
    """

    tree_fields = ("lam",)

    size: int
    lam: Any = 1.0

    def __post_init__(self):
        if not isinstance(self.size, int) or self.size < 1:
            raise ValueError(f"window size must be an int >= 1; got {self.size}")

    def apply_dense(self, a_mat):
        a_mat = _matrix(a_mat)
        m = a_mat.shape[-2]
        kept = a_mat[..., max(0, m - self.size):, :]
        return _tensor(self.lam, kept) * kept

    def out_shape(self, m: int, n: int) -> tuple[int, int]:
        return (min(m, self.size), n)

    def spec(self) -> tuple:
        return ("window", self.size)


@dataclasses.dataclass(frozen=True)
class Compose(UpdateOp):
    """Apply a tuple of ops left-to-right: ``Compose((f, g))`` is "f, then g".

    >>> import numpy as np
    >>> float(Compose((Decay(2.0), Decay(3.0))).apply_dense(np.ones((1, 1)))[0, 0])
    6.0
    """

    ops: tuple

    def __post_init__(self):
        object.__setattr__(self, "ops", tuple(self.ops))
        for child in self.ops:
            if not isinstance(child, UpdateOp):
                raise TypeError(f"Compose takes UpdateOps; got {type(child)}")

    def apply_dense(self, a_mat):
        out = _matrix(a_mat)
        for child in self.ops:
            out = child.apply_dense(out)
        return out

    def out_shape(self, m: int, n: int) -> tuple[int, int]:
        for child in self.ops:
            m, n = child.out_shape(m, n)
        return (m, n)

    def spec(self) -> tuple:
        return ("compose", tuple(child.spec() for child in self.ops))


# -- spec serialisation: tuples key the planner's cache, nested lists go
# through JSON, skeletons rebuild placeholder-leaf ops of the same structure


def spec_to_json(spec: tuple):
    """Tuple spec -> JSON-able nested lists."""
    return [spec_to_json(x) if isinstance(x, tuple) else x for x in spec]


def spec_from_json(spec) -> tuple:
    """JSON nested lists -> hashable tuple spec."""
    return tuple(spec_from_json(x) if isinstance(x, list) else x for x in spec)


def skeleton_from_spec(spec: tuple) -> UpdateOp:
    """An op of the structure ``spec`` describes, with placeholder data.

    >>> skeleton_from_spec(("compose", (("decay",), ("remove_rows", (1,)))))
    Compose(ops=(Decay(lam=0.0), RemoveRows(idx=(1,))))
    """
    kind = spec[0]
    if kind == "rank_k":
        return RankK(u=0.0, v=0.0)
    if kind in ("append_rows", "append_cols"):
        cls = AppendRows if kind == "append_rows" else AppendCols
        if spec[3] == "dense":
            return cls(0.0)
        return cls.from_svd(0.0, 0.0, 0.0)
    if kind == "dense_delta":
        return DenseDelta(delta=0.0, rank=spec[1])
    if kind == "sparse":
        return Sparse(rows=0.0, cols=0.0, vals=0.0, rank=spec[2])
    if kind == "decay":
        return Decay(lam=0.0)
    if kind == "remove_rows":
        return RemoveRows(spec[1])
    if kind == "remove_cols":
        return RemoveCols(spec[1])
    if kind == "window":
        return Window(size=spec[1], lam=0.0)
    if kind == "compose":
        return Compose(tuple(skeleton_from_spec(c) for c in spec[1]))
    raise ValueError(f"unknown op spec {spec!r}")
