"""Rank-1 SVD update (paper Algorithm 6.1) and its Brand-truncated form, plain PyTorch.

Counterpart of ``repro.core.svd_update``.  Given ``A = U diag(s) V^T``
(m <= n) and vectors a, b, the update computes the SVD of ``A + a b^T``
through four diagonal-plus-rank-1 eigen-updates, then a structured sign fix.
Every argument carries a leading batch dimension B; ``core.engine`` adds and
removes it for single updates.  ``method="fused"`` hands the whole update to
``kernels.ops`` (the fused CUDA kernels on a card); ``method="fmm"`` runs the
eigen-updates' Cauchy products through the Chebyshev FMM (``core.fmm``) at
order ``fmm_p``.

The truncated update's (r+1) core is replayed from a CUDA graph
(``core.graph``) on a card, on the ``direct`` route, for r + 1 <=
``secular.GIVENS_LOOP_MAX``, from the second call with its key (device,
dtype, batch, r + 1, ``deflate_rtol``, matmul precision) on; a replay enters
the ``core_update`` span alone, an eager call and the capture also its
phases' spans.  The full update and every other route run eagerly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.eigh_update import apply_update, eigenvalues, make_plan, materialize_q
from repro_torch.core.graph import CORE_GRAPHS
from repro_torch.obs.trace import span

__all__ = ["SvdUpdateResult", "TruncatedSvd"]


class SvdUpdateResult(NamedTuple):
    u: torch.Tensor        # (B, m, m) updated left singular vectors
    s: torch.Tensor        # (B, m) singular values, descending
    v: torch.Tensor        # (B, n, n) updated right singular vectors
    d_left: torch.Tensor   # (B, m) eigenvalues of (A+ab^T)(A+ab^T)^T, descending
    d_right: torch.Tensor  # (B, n) eigenvalues of (A+ab^T)^T(A+ab^T), descending


class TruncatedSvd(NamedTuple):
    u: torch.Tensor  # (B, m, r)
    s: torch.Tensor  # (B, r) descending
    v: torch.Tensor  # (B, n, r)


def _mv(mat, vec):
    return (mat @ vec[:, :, None])[:, :, 0]


def _mtv(mat, vec):
    return (mat.transpose(1, 2) @ vec[:, :, None])[:, :, 0]


def _rank2_symmetric_split(beta):
    """Analytic Schur of ``[[beta, 1], [1, 0]]``: eigenvalues one positive,
    one negative, unit eigenvectors ``[rho_i, 1] / sqrt(1 + rho_i^2)``."""
    h = 0.5 * beta
    r = torch.sqrt(h * h + 1.0)
    rho_pos = h + r
    rho_neg = h - r
    n_pos = torch.sqrt(1.0 + rho_pos * rho_pos)
    n_neg = torch.sqrt(1.0 + rho_neg * rho_neg)
    return rho_pos, rho_neg, (rho_pos / n_pos, 1.0 / n_pos), (rho_neg / n_neg, 1.0 / n_neg)


def _double_update(q0, d0, w1, w2, rho_pos, rho_neg, *, method, fmm_p, want_g,
                   deflate_rtol=None):
    """Two chained eigen-updates of ``Q0 diag(d0) Q0^T``: returns the final
    ascending eigenvalues, ``Q_final = Q0 @ G``, and G when ``want_g``."""
    kw = dict(build_fmm=method == "fmm", fmm_p=fmm_p, deflate_rtol=deflate_rtol)
    z1 = _mtv(q0, w1)
    plan1 = make_plan(d0, z1, rho_pos, rho_positive=True, **kw)
    q1 = apply_update(plan1, q0, method=method)
    d1 = eigenvalues(plan1)

    z2 = _mtv(q1, w2)
    plan2 = make_plan(d1, z2, rho_neg, rho_positive=False, **kw)
    q2 = apply_update(plan2, q1, method=method)
    d2 = eigenvalues(plan2)

    g = None
    if want_g:
        g = apply_update(plan2, materialize_q(plan1, method=method), method=method)
    return d2, q2, g


def _svd_update_impl(u, s, v, a, b, *, method: str = "direct", fmm_p: int = 20,
                     sign_fix: bool = True, deflate_rtol: float | None = None,
                     compute_dtype=None) -> SvdUpdateResult:
    """Algorithm 6.1 over a leading batch dimension.  ``compute_dtype``: 16-bit
    storage computes in float32 (inside the kernel on the fused route)."""
    m = u.shape[1]
    n = v.shape[1]
    if m > n:
        raise ValueError("svd_update expects m <= n; transpose the problem (swap u/v, a/b).")

    if method == "fused":
        from repro_torch.kernels import ops as _kops

        out = _kops.fused_update(u, s, v, a, b, sign_fix=sign_fix,
                                 deflate_rtol=deflate_rtol, compute_dtype=compute_dtype)
        return SvdUpdateResult(*out)

    store_dt = u.dtype
    if compute_dtype is not None and compute_dtype != store_dt:
        res = _svd_update_impl(
            u.to(compute_dtype), s.to(compute_dtype), v.to(compute_dtype),
            a.to(compute_dtype), b.to(compute_dtype),
            method=method, fmm_p=fmm_p, sign_fix=sign_fix, deflate_rtol=deflate_rtol,
        )
        return SvdUpdateResult(*(x.to(store_dt) for x in res))

    dt = u.dtype
    s = s.to(dt)
    bsz = u.shape[0]
    zeros = torch.zeros((bsz, n - m), dtype=dt, device=u.device)

    # STEP 1: structured products (A is never materialised)
    vtb = _mtv(v, b)
    b_t = _mv(u, s * vtb[:, :m])
    uta = _mtv(u, a)
    a_t = _mv(v, torch.cat([s * uta, zeros], dim=1))
    beta = torch.sum(b * b, dim=1)
    alpha = torch.sum(a * a, dim=1)
    d_u = s * s
    d_v = torch.cat([s * s, zeros], dim=1)

    # STEPS 2-3: the 2x2 splits of both sides
    rho1, rho2, qp, qn = _rank2_symmetric_split(beta)
    a1 = qp[0][:, None] * a + qp[1][:, None] * b_t
    b1 = qn[0][:, None] * a + qn[1][:, None] * b_t
    rho3, rho4, qpv, qnv = _rank2_symmetric_split(alpha)
    a2 = qpv[0][:, None] * b + qpv[1][:, None] * a_t
    b2 = qnv[0][:, None] * b + qnv[1][:, None] * a_t

    # STEPS 4-7: chained eigen-updates
    kw = dict(method=method, fmm_p=fmm_p, want_g=sign_fix, deflate_rtol=deflate_rtol)
    d_left, u_n, g_u = _double_update(u, d_u, a1, b1, rho1, rho2, **kw)
    d_right, v_n, g_v = _double_update(v, d_v, a2, b2, rho3, rho4, **kw)

    # STEP 8: singular values, descending (jnp.argsort is stable; so is this)
    ord_l = torch.argsort(-d_left, dim=1, stable=True)
    ord_r = torch.argsort(-d_right, dim=1, stable=True)
    d_left_s = torch.gather(d_left, 1, ord_l)
    d_right_s = torch.gather(d_right, 1, ord_r)
    u_n = torch.gather(u_n, 2, ord_l[:, None, :].expand(bsz, m, m))
    v_n = torch.gather(v_n, 2, ord_r[:, None, :].expand(bsz, n, n))
    s_n = torch.sqrt(torch.clamp(d_left_s, min=0.0))

    if sign_fix:
        # diag_i = u_i^T (A + a b^T) v_i from the structured factors
        g_u = torch.gather(g_u, 2, ord_l[:, None, :].expand(bsz, m, m))
        g_v = torch.gather(g_v, 2, ord_r[:, None, :].expand(bsz, n, n))
        core = torch.sum(s[:, :, None] * g_u * g_v[:, :m, :m], dim=1)
        au = (uta[:, None, :] @ g_u)[:, 0]
        bv = (vtb[:, None, :] @ g_v[:, :, :m])[:, 0]
        diag = core + au * bv
        flip = torch.where(diag < 0, -1.0, 1.0).to(dt)
        v_n = torch.cat([v_n[:, :, :m] * flip[:, None, :], v_n[:, :, m:]], dim=2)

    return SvdUpdateResult(u=u_n, s=s_n, v=v_n, d_left=d_left_s, d_right=d_right_s)


def _core_usv(s_aug, ak, bk, *, method, fmm_p, deflate_rtol):
    """Algorithm 6.1 on Brand's (B, k, k) core: identity factors, the
    augmented spectrum ``s_aug`` and the pair's coordinates ``ak``, ``bk``."""
    bsz, k = s_aug.shape
    eye = torch.eye(k, dtype=s_aug.dtype, device=s_aug.device).expand(bsz, k, k)
    res = _svd_update_impl(eye, s_aug, eye, ak, bk, method=method, fmm_p=fmm_p,
                           sign_fix=True, deflate_rtol=deflate_rtol)
    return res.u, res.s, res.v


def _svd_update_truncated_impl(tsvd, a, b, *, method: str = "direct", fmm_p: int = 20,
                               deflate_rtol: float | None = None,
                               compute_dtype=None) -> TruncatedSvd:
    """Brand augmentation around Algorithm 6.1: u (B, m, r), s (B, r),
    v (B, n, r), a (B, m), b (B, n) -> the same shapes.  Spans (``obs``) off
    the fused route: ``brand_residual``, ``core_update``, ``brand_rotate``.

    The core runs through ``core.graph.CORE_GRAPHS``: on a card, on
    ``direct`` and for r + 1 <= ``GIVENS_LOOP_MAX``, the second call with a
    core key captures it as a CUDA graph and every later one replays it, with
    the same kernels in the same order.  Under a replay ``core_update`` holds
    no child span; eager calls and the capture enter ``deflate``,
    ``secular_solve``, ``loewner``, ``givens`` and ``cauchy_product`` in it."""
    u, s, v = tsvd.u, tsvd.s, tsvd.v

    if method == "fused":
        from repro_torch.kernels import ops as _kops

        out = _kops.fused_update_truncated(u, s, v, a, b, deflate_rtol=deflate_rtol,
                                           compute_dtype=compute_dtype)
        return TruncatedSvd(*out)

    if compute_dtype is not None and compute_dtype != u.dtype:
        store_dt = u.dtype
        res = _svd_update_truncated_impl(
            TruncatedSvd(u.to(compute_dtype), s.to(compute_dtype), v.to(compute_dtype)),
            a.to(compute_dtype), b.to(compute_dtype),
            method=method, fmm_p=fmm_p, deflate_rtol=deflate_rtol,
        )
        return TruncatedSvd(*(x.to(store_dt) for x in res))

    bsz, m, r = u.shape
    dt = u.dtype

    def _residual(basis, x):
        p = _mtv(basis, x)
        perp = x - _mv(basis, p)
        nrm = torch.linalg.vector_norm(perp, dim=1)
        ok = nrm > 1e-12
        unit = torch.where(ok[:, None], perp / torch.where(ok, nrm, 1.0)[:, None], 0.0)
        return p, unit, torch.where(ok, nrm, 0.0)

    with span("brand_residual"):
        p_vec, p_unit, ra = _residual(u, a)
        q_vec, q_unit, rb = _residual(v, b)

        s_aug = torch.cat([s, torch.zeros((bsz, 1), dtype=dt, device=u.device)], dim=1)
        ak = torch.cat([p_vec, ra[:, None]], dim=1)
        bk = torch.cat([q_vec, rb[:, None]], dim=1)
    with span("core_update"):
        core = functools.partial(_core_usv, method=method, fmm_p=fmm_p, deflate_rtol=deflate_rtol)
        cu, cs, cv = CORE_GRAPHS.run(core, s_aug, ak, bk, method=method,
                                     deflate_rtol=deflate_rtol)

    with span("brand_rotate"):
        u_aug = torch.cat([u, p_unit[:, :, None]], dim=2)
        v_aug = torch.cat([v, q_unit[:, :, None]], dim=2)
        return TruncatedSvd(u=u_aug @ cu[:, :, :r], s=cs[:, :r], v=v_aug @ cv[:, :, :r])
