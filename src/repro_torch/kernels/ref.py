"""Plain PyTorch oracles for the kernels (allclose targets in tests).

Counterpart of ``repro.kernels.ref``.  The secular oracle shares its loop
with the fused body (``kernels.secular_body``); the fused-update oracle is
the unfused phase chain (``core.svd_update`` with ``method="direct"``), an
independent implementation of the same algorithm.
"""

from __future__ import annotations

from repro_torch.kernels.cauchy_matmul import cauchy_matmul_plain
from repro_torch.kernels.secular_body import secular_iterate

__all__ = ["cauchy_matmul_ref", "secular_solve_ref", "svd_update_fused_ref"]


def cauchy_matmul_ref(w, src, anchor_vals, tau, tgt_mask):
    """Oracle for the Cauchy kernel (batched: ``w`` (B, R, N))."""
    return cauchy_matmul_plain(w, src, anchor_vals, tau, tgt_mask)


def secular_solve_ref(dc, zc2, rho, anchor_vals, lo, hi, *, n_bisect=58, n_newton=4):
    """Batched secular solve with roots on the last axis."""
    diff = dc[:, :, None] - anchor_vals[:, None, :]
    return secular_iterate(diff, zc2, rho, lo, hi, n_bisect=n_bisect,
                           n_newton=n_newton, poles_axis=0)


def svd_update_fused_ref(u, s, v, a, b, *, sign_fix=True, deflate_rtol=None):
    """Oracle for the fused update: the per-phase chain, ``(u, s, v, d_left,
    d_right)``.  Near-coincident poles may deflate differently, and the
    trailing null columns of ``v`` are an arbitrary basis: compare
    ``v[..., :m]``."""
    from repro_torch.core.svd_update import _svd_update_impl

    return tuple(_svd_update_impl(u, s, v, a, b, method="direct", sign_fix=sign_fix,
                                  deflate_rtol=deflate_rtol))
