"""``SvdState``: the one SVD container every update path speaks, in PyTorch.

Counterpart of ``repro.api.state``.  ``u: (..., m, k)``, ``s: (..., k)``,
``v: (..., n, k)``; ``k == m`` with square ``v`` is the full paper state,
``k < min(m, n)`` the truncated streaming state, and a leading batch axis
(``u.dim() == 3``) marks B stacked problems.  ``d_left``/``d_right`` are the
optional eigen diagnostics of a full update.

The constructors take ``device=``, defaulting to ``"cuda"``: without a card
they raise unless ``device="cpu"`` is given, so nothing runs on the CPU by
accident.  Updates run where the state lives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SvdState", "as_state", "like_container", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def _tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh placement is not ported yet (ROADMAP A7)")


@dataclasses.dataclass(frozen=True)
class SvdState:
    """Immutable SVD state: ``A ≈ u @ diag(s) @ v[..., :k].T``."""

    u: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    d_left: torch.Tensor | None = None
    d_right: torch.Tensor | None = None

    # -- geometry -----------------------------------------------------------

    @property
    def m(self) -> int:
        return self.u.shape[-2]

    @property
    def n(self) -> int:
        return self.v.shape[-2]

    @property
    def rank(self) -> int:
        return self.s.shape[-1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.u.dtype

    @property
    def device(self) -> torch.device:
        return self.u.device

    @property
    def is_full(self) -> bool:
        return (self.u.shape[-1] == self.u.shape[-2]
                and self.v.shape[-1] == self.v.shape[-2]
                and self.s.shape[-1] == self.u.shape[-2])

    @property
    def is_batched(self) -> bool:
        return self.u.dim() == 3

    @property
    def batch(self) -> int | None:
        return self.u.shape[0] if self.is_batched else None

    @property
    def geometry(self) -> tuple:
        """Batching-group key: states sharing it stack into one engine call."""
        return (self.m, self.n, self.rank, self.dtype, self.is_full, self.device)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dense(cls, x, rank: int | None = None, *, device="cuda", dtype=None,
                   mesh=None) -> "SvdState":
        """SVD of a dense matrix (``torch.linalg.svd``): the full paper state
        for ``rank=None`` (requires m <= n), else the rank-r truncated state."""
        _no_mesh(mesh)
        x = _tensor(x, resolve_device(device), dtype)
        if x.dim() != 2:
            raise ValueError(f"from_dense expects a 2-D matrix; got {tuple(x.shape)}")
        m, n = x.shape
        if rank is None:
            if m > n:
                raise ValueError("full SvdState requires m <= n; transpose the problem "
                                 "or pass rank= for a truncated state")
            u, s, vh = torch.linalg.svd(x, full_matrices=True)
            return cls(u=u, s=s, v=vh.mT.contiguous())
        if rank > min(m, n):
            raise ValueError(f"rank {rank} exceeds min(m, n) = {min(m, n)}")
        u, s, vh = torch.linalg.svd(x, full_matrices=False)
        return cls(u=u[:, :rank].contiguous(), s=s[:rank].contiguous(),
                   v=vh[:rank].mT.contiguous())

    @classmethod
    def from_factors(cls, u, s, v, *, device="cuda", dtype=None, mesh=None) -> "SvdState":
        """Wrap existing factors (full or truncated, stacked or single); ``v``
        holds the right singular vectors as COLUMNS."""
        _no_mesh(mesh)
        dev = resolve_device(device)
        u, s, v = (_tensor(x, dev, dtype) for x in (u, s, v))
        if u.dim() != v.dim() or u.dim() != s.dim() + 1 or u.dim() not in (2, 3):
            raise ValueError(f"inconsistent factor ranks: u {tuple(u.shape)}, "
                             f"s {tuple(s.shape)}, v {tuple(v.shape)}")
        if u.shape[-1] != s.shape[-1]:
            raise ValueError(f"u has {u.shape[-1]} columns but s carries {s.shape[-1]} values")
        if v.shape[-1] != s.shape[-1] and v.shape[-1] != v.shape[-2]:
            raise ValueError(f"v has {v.shape[-1]} columns but s carries {s.shape[-1]} values "
                             f"(did you pass vt instead of v = vt.T?)")
        return cls(u=u, s=s, v=v)

    # -- transforms ---------------------------------------------------------

    def replace(self, **kw) -> "SvdState":
        return dataclasses.replace(self, **kw)

    def to(self, dtype) -> "SvdState":
        cast = lambda x: None if x is None else x.to(dtype)  # noqa: E731
        return SvdState(*(cast(x) for x in (self.u, self.s, self.v, self.d_left, self.d_right)))

    def truncate(self, rank: int) -> "SvdState":
        """Keep the top-``rank`` triplets (drops the eigen diagnostics)."""
        if rank > self.rank:
            raise ValueError(f"cannot truncate rank {self.rank} state to {rank}")
        return SvdState(u=self.u[..., :, :rank], s=self.s[..., :rank], v=self.v[..., :, :rank])

    def materialize(self) -> torch.Tensor:
        """Dense ``A = u @ diag(s) @ v_k^T`` (full states use ``v[:, :m]``)."""
        v = self.v[..., :, : self.rank]
        return (self.u * self.s[..., None, :]) @ v.mT


def like_container(tmpl, u, s, v):
    """``(u, s, v)`` in the container type of ``tmpl`` (``SvdState`` or
    ``TruncatedSvd``): layers that transform a caller's container hand the
    same type back."""
    return type(tmpl)(u, s, v)


def as_state(obj) -> SvdState:
    """Coerce an SVD container (``SvdState``, ``TruncatedSvd``,
    ``SvdUpdateResult`` or a ``(u, s, v)`` triple of tensors) to ``SvdState``;
    the state stays on the tensors' device."""
    if isinstance(obj, SvdState):
        return obj
    if getattr(obj, "u", None) is not None:
        return SvdState(u=obj.u, s=obj.s, v=obj.v, d_left=getattr(obj, "d_left", None),
                        d_right=getattr(obj, "d_right", None))
    u, s, v = obj
    if not isinstance(u, torch.Tensor):
        raise TypeError("as_state takes tensors; build a state from arrays with "
                        "SvdState.from_factors(..., device=...)")
    return SvdState.from_factors(u, s, v, device=u.device)
