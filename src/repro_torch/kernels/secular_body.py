"""The bisection + Newton secular loop, plain PyTorch.

Counterpart of ``repro.kernels.secular_body``.  It solves

    w(mu) = 1 + rho * sum_j zc2_j / (dc_j - mu),   mu = anchor + tau,

for every root at once, on a precomputed difference tensor
``diff = dc - anchor``.  Every tensor carries a leading batch dimension.
The CUDA form of this loop is ``secular_iterate`` in ``csrc/fused_core.cuh``,
which recomputes ``diff`` on the fly instead of storing it.
"""

from __future__ import annotations

import torch

__all__ = ["secular_iterate"]


def secular_iterate(diff, zc2, rho, lo, hi, *, n_bisect: int = 58,
                    n_newton: int = 4, poles_axis: int = 0):
    """Fixed-count bisection + safeguarded pole-free Newton solve.

    ``poles_axis == 0``: ``diff[b, j, i] = dc_j - anchor_i`` (roots on the
    last axis).  ``poles_axis == 1``: ``diff[b, i, j]`` (roots on axis 1).
    ``zc2``: (B, N), already zero at invalid sources; ``rho``: (B,);
    ``lo``/``hi``: (B, M).  Returns ``tau`` (B, M), clipped to the bracket.
    """
    if poles_axis == 0:
        diff = diff.transpose(1, 2)
    elif poles_axis != 1:
        raise ValueError(f"poles_axis must be 0 or 1; got {poles_axis}")
    tiny = torch.finfo(diff.dtype).tiny
    rho_ = rho[:, None]
    zc2_ = zc2[:, None, :]

    def _inv(tau):
        # the subtraction order (d_j - anchor_i) - tau_i is what keeps roots
        # that hug a pole accurate
        delta = diff - tau[:, :, None]
        return torch.where(delta == 0.0, 0.0, 1.0 / delta)

    lo_c, hi_c = lo, hi
    for _ in range(n_bisect):
        mid = 0.5 * (lo_c + hi_c)
        w = 1.0 + rho_ * torch.sum(zc2_ * _inv(mid), dim=2)
        go_right = w < 0.0
        lo_c, hi_c = torch.where(go_right, mid, lo_c), torch.where(go_right, hi_c, mid)

    # Newton on f(tau) = tau * w(tau), which is smooth across the anchor
    # pole; each step folds the sign into the bracket and is accepted on the
    # CLOSED bracket (see repro.kernels.secular_body for why).
    tau = 0.5 * (lo_c + hi_c)
    for _ in range(n_newton):
        inv = _inv(tau)
        r = zc2_ * inv
        w = 1.0 + rho_ * torch.sum(r, dim=2)
        wp = rho_ * torch.sum(r * inv, dim=2)
        go_right = w < 0.0
        lo_c = torch.where(go_right, tau, lo_c)
        hi_c = torch.where(go_right, hi_c, tau)
        fp = w + tau * wp
        safe_fp = torch.where(fp == 0.0, tiny, fp)
        cand = tau - tau * w / safe_fp
        inside = (cand >= lo_c) & (cand <= hi_c)
        tau = torch.where(inside, cand, 0.5 * (lo_c + hi_c))
    return tau
