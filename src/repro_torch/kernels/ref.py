"""Plain PyTorch oracles for the kernels (allclose targets in tests).

Counterpart of ``repro.kernels.ref``.  The secular oracle shares its loop
with the fused body (``kernels.secular_body``); the fused-update oracle is
the unfused phase chain (``core.svd_update`` with ``method="direct"``), an
independent implementation of the same algorithm.
"""

from __future__ import annotations

from repro_torch.kernels.cauchy_matmul import cauchy_matmul_plain
from repro_torch.kernels.nearfield import nearfield_plain
from repro_torch.kernels.secular_newton import secular_solve_plain

__all__ = ["cauchy_matmul_ref", "secular_solve_ref", "nearfield_ref", "svd_update_fused_ref"]


def cauchy_matmul_ref(w, src, anchor_vals, tau, tgt_mask):
    """Oracle for the Cauchy kernel (batched: ``w`` (B, R, N))."""
    return cauchy_matmul_plain(w, src, anchor_vals, tau, tgt_mask)


def secular_solve_ref(dc, zc2, rho, anchor_vals, lo, hi, *, n_bisect=58, n_newton=4):
    """Oracle for the secular kernel: the batched solve with roots on the last axis."""
    return secular_solve_plain(dc, zc2, rho, anchor_vals, lo, hi, n_bisect=n_bisect,
                               n_newton=n_newton)


def nearfield_ref(w_near, x_near, av_b, tau_b, tgt_mask):
    """Oracle for the near-field kernel (batched: ``w_near`` (B, R, nb, 3cap))."""
    return nearfield_plain(w_near, x_near, av_b, tau_b, tgt_mask)


def svd_update_fused_ref(u, s, v, a, b, *, sign_fix=True, deflate_rtol=None):
    """Oracle for the fused update: the per-phase chain, ``(u, s, v, d_left,
    d_right)``.  Near-coincident poles may deflate differently, and the
    trailing null columns of ``v`` are an arbitrary basis: compare
    ``v[..., :m]``."""
    from repro_torch.core.svd_update import _svd_update_impl

    return tuple(_svd_update_impl(u, s, v, a, b, method="direct", sign_fix=sign_fix,
                                  deflate_rtol=deflate_rtol))
