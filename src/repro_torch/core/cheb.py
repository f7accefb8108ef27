"""Chebyshev nodes and Lagrange interpolation operators (paper App. D.1), plain PyTorch.

Counterpart of ``repro.core.cheb``, shared by ``core.fmm`` and its tests.
Nodes follow the paper's Eq. (D.1):  t_i = cos((2i-1)/p * pi/2), i = 1..p
(first-kind Chebyshev nodes on [-1, 1]), ascending.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cheb_nodes", "lagrange_eval", "lagrange_matrix"]


def cheb_nodes(p: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """First-kind Chebyshev nodes, paper Eq. (D.1), ascending."""
    i = torch.arange(1, p + 1, dtype=dtype, device=device)
    t = torch.cos((2.0 * i - 1.0) / (2.0 * p) * math.pi)
    return torch.flip(t, dims=(0,))


def lagrange_eval(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``L[q, ...] = u_q(x[...])``: the Lagrange basis at nodes ``t`` evaluated
    at ``x`` (any shape); the output is ``(p, *x.shape)``.

    Paper Eq. (D.2), in the direct product form (stable for p <= ~40 in f64)."""
    p = t.shape[0]
    xf = x.reshape(-1)
    # num[q, k] = prod_{j != q} (x_k - t_j); den[q] = prod_{j != q} (t_q - t_j)
    diff_x = xf[None, :] - t[:, None]
    eye = torch.eye(p, dtype=torch.bool, device=t.device)
    num = torch.prod(torch.where(eye[:, :, None], 1.0, diff_x[None, :, :]), dim=1)
    den = torch.prod(torch.where(eye, 1.0, t[:, None] - t[None, :]), dim=1)
    return (num / den[:, None]).reshape((p,) + tuple(x.shape))


def lagrange_matrix(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Interpolation matrix ``P[..., q] = u_q(x[...])``: f(x) ~ P @ f(t)."""
    return torch.movedim(lagrange_eval(t, x), 0, -1)
