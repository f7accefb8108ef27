"""Direct Cauchy-matrix products (Trummer's problem), plain PyTorch.

Counterpart of ``repro.core.cauchy``.  ``C[j, i] = 1 / (src_j - mu_i)``; the
stable form takes the targets anchored, ``mu_i = src[anchor_i] + tau_i``, so
a root that hugs a pole keeps its accuracy; ``cauchy_matmul`` takes raw
coordinates, for sources and targets well apart.  Tensors carry a leading
batch dimension, or none for one member as in the reference
(``core._single``); products are chunked over targets so no more than a
chunk of the (N, M) matrix exists at a time.
"""

from __future__ import annotations

import torch

from repro_torch.core._single import single_member

__all__ = ["cauchy_matrix", "cauchy_matvec", "cauchy_matmul", "cauchy_matmul_stable",
           "cauchy_colnorms_stable"]


@single_member(2)
def cauchy_matrix(src, tgt):
    """``C[b, j, i] = 1 / (src_bj - tgt_bi)``."""
    return 1.0 / (src[:, :, None] - tgt[:, None, :])


@single_member(2)
def cauchy_matvec(weights, src, tgt):
    """``f[b, i] = sum_j weights[b, j] / (src_bj - tgt_bi)``.

    One member, as the reference takes it, and a batch of two:

    >>> src = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    >>> tgt = torch.tensor([1.5, 3.0], dtype=torch.float64)
    >>> [round(x, 12) for x in cauchy_matvec(torch.ones(3, dtype=torch.float64), src, tgt).tolist()]
    [0.4, -0.5]
    >>> tuple(cauchy_matvec(torch.ones(2, 3, dtype=torch.float64), src.expand(2, 3),
    ...                     tgt.expand(2, 2)).shape)
    (2, 2)
    """
    return cauchy_matmul(weights[:, None, :], src, tgt)[:, 0]


@single_member(3)
def cauchy_matmul(w, src, tgt, *, chunk: int = 2048):
    """``out[b, r, i] = sum_j w[b, r, j] / (src_bj - tgt_bi)`` for ``w`` (B, R, N):
    a chunk of the Cauchy matrix at a time, then its product."""
    m = tgt.shape[1]
    return torch.cat([w @ (1.0 / (src[:, :, None] - tgt[:, None, lo:lo + chunk]))
                      for lo in range(0, m, chunk)], dim=2)


@single_member(3)
def cauchy_matmul_stable(w, src, anchor, tau, *, src_valid=None, tgt_valid=None,
                         chunk: int = 2048):
    """``out[b, r, i] = sum_j w[b, r, j] / (src_bj - mu_bi)`` with the
    denominator taken as ``(src_j - src[anchor_i]) - tau_i``; invalid sources
    and targets are masked out."""
    bsz, _, n = w.shape
    m = anchor.shape[1]
    if src_valid is None:
        src_valid = torch.ones((bsz, n), dtype=torch.bool, device=w.device)
    if tgt_valid is None:
        tgt_valid = torch.ones((bsz, m), dtype=torch.bool, device=w.device)
    w = torch.where(src_valid[:, None, :], w, 0.0)
    anchor_vals = torch.gather(src, 1, anchor)
    outs = []
    for lo in range(0, m, chunk):
        av, tv, vv = (x[:, lo:lo + chunk] for x in (anchor_vals, tau, tgt_valid))
        delta = (src[:, :, None] - av[:, None, :]) - tv[:, None, :]
        safe = torch.where(delta == 0.0, 1.0, delta)
        mask = src_valid[:, :, None] & vv[:, None, :] & (delta != 0.0)
        outs.append(w @ torch.where(mask, 1.0 / safe, 0.0))
    return torch.cat(outs, dim=2)


@single_member(2)
def cauchy_colnorms_stable(zhat, src, anchor, tau, *, src_valid=None, tgt_valid=None):
    """Norms of the scaled Cauchy columns, ``sum_j zhat_j^2 / (src_j - mu_i)^2``
    under the square root; invalid targets get norm 1."""
    bsz, n = src.shape
    m = anchor.shape[1]
    if src_valid is None:
        src_valid = torch.ones((bsz, n), dtype=torch.bool, device=src.device)
    if tgt_valid is None:
        tgt_valid = torch.ones((bsz, m), dtype=torch.bool, device=src.device)
    anchor_vals = torch.gather(src, 1, anchor)
    delta = (src[:, :, None] - anchor_vals[:, None, :]) - tau[:, None, :]
    safe = torch.where(delta == 0.0, 1.0, delta)
    inv2 = torch.where(src_valid[:, :, None] & (delta != 0.0), 1.0 / (safe * safe), 0.0)
    nrm = torch.sqrt(torch.sum((zhat * zhat)[:, :, None] * inv2, dim=1))
    return torch.where(tgt_valid, nrm, 1.0)
