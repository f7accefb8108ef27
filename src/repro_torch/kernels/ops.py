"""Dispatch to the kernels.

Counterpart of ``repro.kernels.ops``.  A CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the hand-written kernel or raises.  There is
no fallback between the two.  The reference's ``custom_vmap`` rules collapse
into the explicit leading batch dimension every function here takes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cauchy_matmul import cauchy_matmul
from repro_torch.kernels.fused_update import (
    fused_update_batched,
    fused_update_truncated_batched,
)
from repro_torch.kernels.nearfield import nearfield as _nearfield
from repro_torch.kernels.secular_newton import secular_solve as _secular_solve
from repro_torch.kernels.sparse_proj import sparse_project

__all__ = ["cauchy_matmul_stable", "fused_update", "fused_update_truncated", "nearfield",
           "secular_solve", "sparse_project"]


def cauchy_matmul_stable(w, src, anchor, tau, *, src_valid=None, tgt_valid=None):
    """Kernel-backed ``core.cauchy.cauchy_matmul_stable``:
    ``out[b, r, i] = sum_j w[b, r, j] / (src_bj - mu_bi)`` with
    ``mu_bi = src[b, anchor_bi] + tau_bi``."""
    bsz, _, n = w.shape
    m = anchor.shape[1]
    if src_valid is None:
        src_valid = torch.ones((bsz, n), dtype=torch.bool, device=w.device)
    if tgt_valid is None:
        tgt_valid = torch.ones((bsz, m), dtype=torch.bool, device=w.device)
    w_masked = torch.where(src_valid[:, None, :], w, 0.0).contiguous()
    anchor_vals = torch.gather(src, 1, anchor)
    return cauchy_matmul(w_masked, src.contiguous(), anchor_vals.contiguous(),
                         tau.contiguous(), tgt_valid.contiguous())


def secular_solve(dc, zc2, rho, anchor_vals, lo, hi, *, n_bisect=58, n_newton=4):
    """``tau`` (B, M) with ``w(anchor_vals + tau) = 0`` on ``[lo, hi]``, poles
    ``dc`` (B, N) with weights ``zc2`` (zero at invalid poles), ``rho`` (B,)."""
    return _secular_solve(*(x.contiguous() for x in (dc, zc2, rho, anchor_vals, lo, hi)),
                          n_bisect=n_bisect, n_newton=n_newton)


def nearfield(w_near, x_near, av_b, tau_b, tgt_mask):
    """The FMM near field: ``out[b, r, box, t] = sum_c w_near[b, r, box, c] /
    ((av_b - x_near) + tau_b)`` over the box's 3cap neighbour sources, masked
    by ``tgt_mask``; ``w_near`` zero at invalid source slots."""
    return _nearfield(*(x.contiguous() for x in (w_near, x_near, av_b, tau_b, tgt_mask)))


def fused_update(u, s, v, a, b, *, sign_fix=True, deflate_rtol=None, compute_dtype=None):
    """The fused full update over a leading batch dimension: ``(u, s, v,
    d_left, d_right)``."""
    return fused_update_batched(*(x.contiguous() for x in (u, s, v, a, b)),
                                sign_fix=sign_fix, deflate_rtol=deflate_rtol,
                                compute_dtype=compute_dtype)


def fused_update_truncated(u, s, v, a, b, *, deflate_rtol=None, compute_dtype=None):
    """The fused truncated update over a leading batch dimension: ``(u, s, v)``."""
    return fused_update_truncated_batched(*(x.contiguous() for x in (u, s, v, a, b)),
                                          deflate_rtol=deflate_rtol,
                                          compute_dtype=compute_dtype)
