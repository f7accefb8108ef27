"""Symmetric diagonal-plus-rank-1 eigen-update (paper Algorithm 6.2), plain PyTorch.

Counterpart of ``repro.core.eigh_update`` for the ``direct`` and ``kernel``
methods.  ``make_plan`` builds the eigenvector rotation Q of
``diag(d) + rho z z^T`` as a structured operator (sort permutation, deflation
rotations, compaction, scaled-Cauchy block, output order); ``apply_update``
evaluates ``w @ Q``.  ``method="kernel"`` runs the Cauchy block through
``kernels.ops.cauchy_matmul_stable`` (the hand-written CUDA kernel on a card).
Every field and argument has a leading batch dimension.

``torch.argsort`` is not stable by default, while ``jnp.argsort`` is; the
sorts here pass ``stable=True``, because the n - m structural zeros of the
right-hand problem are exact ties.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import cauchy as _cauchy
from repro_torch.core.secular import (
    apply_givens_columns,
    deflate,
    loewner_zhat,
    secular_solve,
)

__all__ = [
    "EighUpdatePlan",
    "make_plan",
    "eigenvalues",
    "apply_update",
    "materialize_q",
    "eigh_update",
]

_METHODS = ("direct", "kernel")


@dataclasses.dataclass(frozen=True)
class EighUpdatePlan:
    sort_idx: torch.Tensor   # (B, n) ascending-d permutation of the (negated) problem
    givens_a: torch.Tensor
    givens_b: torch.Tensor
    givens_c: torch.Tensor
    givens_s: torch.Tensor
    any_rot: torch.Tensor
    compact: torch.Tensor    # retained-first permutation (on the sorted problem)
    dc: torch.Tensor         # sorted + compacted poles
    zc: torch.Tensor         # merged z, compacted
    rho: torch.Tensor        # (B,) positive rho of the solved problem
    zhat: torch.Tensor       # Loewner weights (0 on padding)
    mu: torch.Tensor         # secular roots (compacted positions)
    anchor: torch.Tensor
    tau: torch.Tensor
    valid: torch.Tensor
    colnorm: torch.Tensor    # scaled-Cauchy column norms (1 on padding)
    mu_full: torch.Tensor    # eigenvalues in compacted positions
    out_sort: torch.Tensor   # final ascending order
    n: int
    negated: bool            # the problem was negated to make rho positive


def _take(x, idx):
    """``x[b, ..., idx[b, j]]`` along the last axis."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 2, idx[:, None, :].expand(x.shape[0], x.shape[1], idx.shape[1]))


def make_plan(d, z, rho, *, rho_positive: bool, deflate_rtol: float | None = None,
              build_fmm: bool = False) -> EighUpdatePlan:
    """Structured eigen-update operator for ``diag(d) + rho z z^T``.

    ``rho_positive`` is the static sign of rho; for rho < 0 the problem is
    negated (same eigenvectors, negated and reversed eigenvalues)."""
    if build_fmm:
        raise NotImplementedError(
            "the FMM route is not ported yet (ROADMAP A3: core/cheb.py, core/fmm.py)")
    n = d.shape[1]
    negated = not rho_positive
    d_w = -d if negated else d
    rho_w = -rho if negated else rho

    sort_idx = torch.argsort(d_w, dim=1, stable=True)
    ds = torch.gather(d_w, 1, sort_idx)
    zs = torch.gather(z, 1, sort_idx)

    defl = deflate(ds, zs, rho_w, rtol=deflate_rtol)
    dc = torch.gather(ds, 1, defl.compact)
    zc = torch.gather(defl.z, 1, defl.compact)

    roots = secular_solve(dc, zc, rho_w, defl.n_keep)
    zhat = loewner_zhat(dc, zc, rho_w, roots)
    colnorm = _cauchy.cauchy_colnorms_stable(
        zhat, dc, roots.anchor, roots.tau, src_valid=roots.valid, tgt_valid=roots.valid)
    mu_full = torch.where(roots.valid, roots.mu, dc)
    out_sort = torch.argsort(mu_full, dim=1, stable=True)
    return EighUpdatePlan(
        sort_idx=sort_idx, givens_a=defl.givens_a, givens_b=defl.givens_b,
        givens_c=defl.givens_c, givens_s=defl.givens_s, any_rot=defl.any_rot,
        compact=defl.compact, dc=dc, zc=zc, rho=rho_w, zhat=zhat, mu=roots.mu,
        anchor=roots.anchor, tau=roots.tau, valid=roots.valid, colnorm=colnorm,
        mu_full=mu_full, out_sort=out_sort, n=n, negated=negated,
    )


def eigenvalues(plan: EighUpdatePlan):
    """Eigenvalues of ``diag(d) + rho z z^T``, ascending."""
    mu = torch.gather(plan.mu_full, 1, plan.out_sort)
    if plan.negated:
        mu = -torch.flip(mu, dims=(1,))
    return mu


def _cauchy_block(plan: EighUpdatePlan, wc, method: str):
    wz = wc * plan.zhat[:, None, :]
    if method == "kernel":
        from repro_torch.kernels import ops as _kops

        out = _kops.cauchy_matmul_stable(wz, plan.dc, plan.anchor, plan.tau,
                                         src_valid=plan.valid, tgt_valid=plan.valid)
    else:
        out = _cauchy.cauchy_matmul_stable(wz, plan.dc, plan.anchor, plan.tau,
                                           src_valid=plan.valid, tgt_valid=plan.valid)
    return out / plan.colnorm[:, None, :]


def apply_update(plan: EighUpdatePlan, w, *, method: str = "direct"):
    """``w @ Q`` for ``w`` (B, m, n), Q's columns the eigenvectors in ascending
    order: sort, deflation rotations, compaction, scaled-Cauchy product with
    deflated columns passing through, final order."""
    if method not in _METHODS:
        if method == "fmm":
            raise NotImplementedError(
                "the FMM route is not ported yet (ROADMAP A3: core/cheb.py, core/fmm.py)")
        raise ValueError(f"unknown method {method!r}; one of {_METHODS}")
    ws = _take(w, plan.sort_idx)
    ws = apply_givens_columns(ws, plan.givens_a, plan.givens_b, plan.givens_c,
                              plan.givens_s, plan.any_rot)
    wc = _take(ws, plan.compact)
    cau = _cauchy_block(plan, wc, method)
    out = _take(torch.where(plan.valid[:, None, :], cau, wc), plan.out_sort)
    if plan.negated:
        out = torch.flip(out, dims=(2,))
    return out


def materialize_q(plan: EighUpdatePlan, *, method: str = "direct", dtype=None):
    """The dense (B, n, n) eigenvector rotation Q (ascending-mu columns)."""
    dt = dtype or plan.dc.dtype
    eye = torch.eye(plan.n, dtype=dt, device=plan.dc.device)
    return apply_update(plan, eye.expand(plan.dc.shape[0], plan.n, plan.n), method=method)


def eigh_update(u, d, z, rho, *, rho_positive: bool, method: str = "direct"):
    """``(mu, U_new)`` for ``U diag(d) U^T + rho (Uz)(Uz)^T = U_new diag(mu) U_new^T``."""
    plan = make_plan(d, z, rho, rho_positive=rho_positive, build_fmm=(method == "fmm"))
    return eigenvalues(plan), apply_update(plan, u, method=method)
