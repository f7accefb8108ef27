"""Secular-equation machinery for ``eig(diag(d) + rho z z^T)``, plain PyTorch.

Counterpart of ``repro.core.secular``: Bunch–Nielsen–Sorensen deflation
with recorded Givens rotations, the anchored bisection + Newton secular
solve, and the Gu–Eisenstat (Loewner) reweighting of ``z``.  Every function
takes tensors with a leading batch dimension ``B``; the sequential Givens
chain of the deflation is a Python loop over the coordinate, vectorised over
the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "DeflationResult",
    "SecularBrackets",
    "SecularRoots",
    "deflate",
    "apply_givens_columns",
    "secular_brackets",
    "secular_solve",
    "loewner_zhat",
    "mu_minus_d",
]


class DeflationResult(NamedTuple):
    """Static-shape description of a deflated ``D + rho z z^T`` (all (B, n))."""

    d: torch.Tensor          # diagonal, ascending (unchanged values)
    z: torch.Tensor          # z after Givens merging (zeros at deflated slots)
    keep: torch.Tensor       # bool
    n_keep: torch.Tensor     # (B,) int
    givens_a: torch.Tensor   # first coordinate of rotation i (or i)
    givens_b: torch.Tensor   # second coordinate of rotation i
    givens_c: torch.Tensor   # rotation cosines (1 where identity)
    givens_s: torch.Tensor   # rotation sines (0 where identity)
    any_rot: torch.Tensor    # (B,) bool
    compact: torch.Tensor    # retained-first stable permutation


def deflate(d, z, rho, *, rtol: float | None = None) -> DeflationResult:
    """BNS deflation for ``D + rho z z^T`` (rho > 0, d ascending), LAPACK
    style: each entry is compared with the last *retained* entry."""
    bsz, n = d.shape
    dt = d.dtype
    fi = torch.finfo(dt)
    if rtol is None:
        rtol = 64.0 * fi.eps
    ar = torch.arange(n, device=d.device)

    znorm2 = torch.sum(z * z, dim=1)
    scale = torch.maximum(torch.amax(torch.abs(d), dim=1), torch.abs(rho) * znorm2) + fi.tiny
    tol = rtol * scale

    z_arr = z.clone()
    last = torch.full((bsz,), -1, dtype=torch.long, device=d.device)
    gas, gbs, cs, ss = [], [], [], []
    for i in range(n):
        zi = z_arr[:, i]
        tiny_i = torch.abs(rho) * zi * zi <= tol
        have_last = last >= 0
        lastc = torch.clamp(last, min=0)
        zl = torch.gather(z_arr, 1, lastc[:, None])[:, 0]
        gap = d[:, i] - torch.gather(d, 1, lastc[:, None])[:, 0]
        r = torch.sqrt(zl * zl + zi * zi)
        safe_r = torch.where(r > 0, r, 1.0)
        c = torch.where(r > 0, zi / safe_r, 1.0)
        s = torch.where(r > 0, -zl / safe_r, 0.0)
        offdiag = torch.abs(c * s * gap)
        do_rot = have_last & ~tiny_i & (offdiag <= tol) & (torch.abs(zl) > 0)
        c = torch.where(do_rot, c, 1.0)
        s = torch.where(do_rot, s, 0.0)
        clear = do_rot[:, None] & (ar[None, :] == lastc[:, None])
        z_arr = torch.where(clear, 0.0, z_arr)
        z_arr[:, i] = torch.where(do_rot, r, z_arr[:, i])
        last = torch.where(tiny_i, last, i)
        gas.append(torch.where(do_rot, lastc, i))
        gbs.append(torch.full_like(lastc, i))
        cs.append(c)
        ss.append(s)

    givens_s = torch.stack(ss, 1)
    keep = torch.abs(rho)[:, None] * z_arr * z_arr > tol[:, None]
    z_final = torch.where(keep, z_arr, 0.0)
    n_keep = keep.sum(1)
    compact = torch.argsort(torch.where(keep, 0, 1), dim=1, stable=True)
    any_rot = torch.any(givens_s != 0.0, dim=1)
    return DeflationResult(d, z_final, keep, n_keep, torch.stack(gas, 1),
                           torch.stack(gbs, 1), torch.stack(cs, 1), givens_s,
                           any_rot, compact)


# the widest problem whose Givens loop runs on a card without asking the host
GIVENS_LOOP_MAX = 64


def apply_givens_columns(w, a_idx, b_idx, c, s, any_rot):
    """Apply the recorded deflation rotations to the columns of ``w`` (B, m, n)
    in forward order: ``col_a' = c col_a + s col_b``, ``col_b' = -s col_a +
    c col_b``.  Batch elements without a rotation are left as they are.

    The loop costs about eight launches a coordinate.  Up to
    ``GIVENS_LOOP_MAX`` coordinates (the service's truncated cores, k = r + 1)
    it runs on a card whether or not a member rotates, and ``any_rot``
    selects per member, as the reference's ``lax.cond`` decides on the
    device: asking the host would wait for the device and make an
    asynchronous round synchronous.  Above it, and always on the CPU, the
    host asks once whether any member rotates and skips the loop when none
    does: there the phase chain is host-bound, so the device has caught up
    by the time the host asks, and the wait is cheaper than the launches."""
    bsz, m, n = w.shape
    if n < 2:
        return w
    if (not w.is_cuda or n > GIVENS_LOOP_MAX) and not bool(torch.any(any_rot)):
        return w
    out = w.clone()
    rows = torch.arange(bsz, device=w.device)
    for i in range(n):
        ai, bi = a_idx[:, i], b_idx[:, i]
        ci, si = c[:, i, None], s[:, i, None]
        col_a = out[rows, :, ai]
        col_b = out[rows, :, bi]
        out[rows, :, ai] = ci * col_a + si * col_b
        out[rows, :, bi] = -si * col_a + ci * col_b
    return torch.where(any_rot[:, None, None], out, w)


class SecularRoots(NamedTuple):
    """Roots of the compacted problem, ``mu_i = dc[anchor_i] + tau_i``; entries
    ``i >= n_keep`` are padding (mu = dc_i, tau = 0).  All (B, n)."""

    mu: torch.Tensor
    anchor: torch.Tensor
    tau: torch.Tensor
    valid: torch.Tensor


def _eval_w_and_deriv(dc, zc2, rho, anchor_vals, tau, valid_src):
    """w(mu) and w'(mu) with roots on axis 1 and sources on axis 2."""
    delta = (dc[:, None, :] - anchor_vals[:, :, None]) - tau[:, :, None]
    safe = torch.where(delta == 0.0, 1.0, delta)
    inv = torch.where(valid_src[:, None, :], 1.0 / safe, 0.0)
    rho_ = rho[:, None]
    w = 1.0 + rho_ * torch.sum(zc2[:, None, :] * inv, dim=2)
    wp = rho_ * torch.sum(zc2[:, None, :] * inv * inv, dim=2)
    return w, wp


class SecularBrackets(NamedTuple):
    """The anchored bracket of every root of a compacted problem (all (B, n)):
    root i lies at ``anchor_vals_i + tau`` with ``tau`` in ``[lo_i, hi_i]``;
    ``zc2`` is ``zc^2``, zero at the padding."""

    anchor: torch.Tensor
    anchor_vals: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    valid: torch.Tensor
    zc2: torch.Tensor


def secular_brackets(dc, zc, rho, n_keep) -> SecularBrackets:
    """Anchor each root at the nearer pole of its interval: the left one if
    ``w`` is positive at the midpoint (and always for the last root), else
    the right one."""
    bsz, n = dc.shape
    idx = torch.arange(n, device=dc.device)[None, :].expand(bsz, n)
    valid = idx < n_keep[:, None]
    zc2 = torch.where(valid, zc * zc, 0.0)
    znorm2 = torch.sum(zc2, dim=1, keepdim=True)

    is_last = idx == (n_keep[:, None] - 1)
    d_right = torch.roll(dc, -1, dims=1)
    right = torch.where(is_last, dc + rho[:, None] * znorm2, d_right)
    left = dc
    width = right - left

    w_mid, _ = _eval_w_and_deriv(dc, zc2, rho, left, 0.5 * width, valid)
    use_left = (w_mid > 0.0) | is_last
    anchor_idx = torch.where(use_left, idx, torch.clamp(idx + 1, max=n - 1))
    anchor_vals = torch.where(use_left, left, right)
    lo = torch.where(use_left, 0.0, -0.5 * width)
    hi = torch.where(is_last, width, torch.where(use_left, 0.5 * width, 0.0))
    return SecularBrackets(anchor_idx, anchor_vals, lo, hi, valid, zc2)


def secular_solve(dc, zc, rho, n_keep, *, n_bisect: int = 58,
                  n_newton: int = 4) -> SecularRoots:
    """Solve the compacted secular equation (rho > 0): retained poles first,
    ascending over the first ``n_keep``."""
    n = dc.shape[1]
    tiny = torch.finfo(dc.dtype).tiny
    idx = torch.arange(n, device=dc.device)[None, :]
    anchor_idx, anchor_vals, lo, hi, valid, zc2 = secular_brackets(dc, zc, rho, n_keep)

    for _ in range(n_bisect):
        tmid = 0.5 * (lo + hi)
        w, _ = _eval_w_and_deriv(dc, zc2, rho, anchor_vals, tmid, valid)
        go_right = w < 0.0
        lo, hi = torch.where(go_right, tmid, lo), torch.where(go_right, hi, tmid)
    tau = 0.5 * (lo + hi)

    for _ in range(n_newton):
        w, wp = _eval_w_and_deriv(dc, zc2, rho, anchor_vals, tau, valid)
        tau = torch.minimum(torch.maximum(tau - w / torch.clamp(wp, min=tiny), lo), hi)

    mu = torch.where(valid, anchor_vals + tau, dc)
    tau = torch.where(valid, tau, 0.0)
    anchor_idx = torch.where(valid, anchor_idx, idx)
    return SecularRoots(mu, anchor_idx, tau, valid)


def mu_minus_d(roots: SecularRoots, dc):
    """Accurate ``delta[b, i, j] = mu_i - dc_j`` from the anchored roots."""
    anchor_vals = torch.gather(dc, 1, roots.anchor)
    return (anchor_vals[:, :, None] - dc[:, None, :]) + roots.tau[:, :, None]


def loewner_zhat(dc, zc, rho, roots: SecularRoots):
    """Gu–Eisenstat ``zhat`` from the solved roots, in log-magnitude space:
    ``zhat_j^2 = prod_i (mu_i - dc_j) / (rho prod_{i != j} (dc_i - dc_j))``.
    Signs follow ``zc``; padding entries are 0."""
    n = dc.shape[1]
    tiny = torch.finfo(dc.dtype).tiny
    valid = roots.valid
    delta = mu_minus_d(roots, dc)
    num = torch.where(valid[:, :, None], delta, 1.0)
    log_num = torch.sum(torch.log(torch.abs(num) + tiny), dim=1)
    dd = dc[:, :, None] - dc[:, None, :]
    idx = torch.arange(n, device=dc.device)
    offdiag = (idx[:, None] != idx[None, :])[None] & valid[:, :, None]
    den = torch.where(offdiag, dd, 1.0)
    log_den = torch.sum(torch.log(torch.abs(den) + tiny), dim=1)
    log_zhat2 = log_num - log_den - torch.log(torch.abs(rho))[:, None]
    zhat = torch.sign(zc) * torch.exp(0.5 * log_zhat2)
    return torch.where(valid, zhat, 0.0)
