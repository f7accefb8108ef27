"""Symmetric diagonal-plus-rank-1 eigen-update (paper Algorithm 6.2), plain PyTorch.

Counterpart of ``repro.core.eigh_update``.  ``make_plan`` builds the
eigenvector rotation Q of ``diag(d) + rho z z^T`` as a structured operator
(sort permutation, deflation rotations, compaction, scaled-Cauchy block,
output order); ``apply_update`` evaluates ``w @ Q``.  The Cauchy block runs
as a dense stable product (``method="direct"``), through
``kernels.ops.cauchy_matmul_stable`` (``"kernel"``: kernel C on a card), or
through the Chebyshev FMM of ``core.fmm`` (``"fmm"``, for problems of at
least ``FMM_MIN_N`` poles; its near field is kernel E on a card).  Every
field and argument has a leading batch dimension.

A member whose FMM plan overflowed its static box capacity takes the dense
stable product instead, as the reference's ``lax.cond`` does: ``make_plan``
reads the overflow flags once per plan (one host read) and records the
members in ``core.fmm.OVERFLOWED``.

``torch.argsort`` is not stable by default, while ``jnp.argsort`` is; the
sorts here pass ``stable=True``, because the n - m structural zeros of the
right-hand problem are exact ties.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import cauchy as _cauchy
from repro_torch.core import fmm as _fmm
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
    "FMM_MIN_N",
]

_METHODS = ("direct", "kernel", "fmm")

# below this many poles the FMM tree is pointless and the plan takes the
# direct route (the reference's _FMM_MIN_N)
FMM_MIN_N = 96


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
    fmm: _fmm.FmmPlan | None
    n: int
    negated: bool            # the problem was negated to make rho positive
    has_fmm: bool
    fmm_overflow: tuple[int, ...]  # members whose FMM plan overflowed


def _take(x, idx):
    """``x[b, ..., idx[b, j]]`` along the last axis."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 2, idx[:, None, :].expand(x.shape[0], x.shape[1], idx.shape[1]))


def make_plan(d, z, rho, *, rho_positive: bool, fmm_p: int = 20, build_fmm: bool = False,
              deflate_rtol: float | None = None) -> EighUpdatePlan:
    """Structured eigen-update operator for ``diag(d) + rho z z^T``.

    ``rho_positive`` is the static sign of rho; for rho < 0 the problem is
    negated (same eigenvectors, negated and reversed eigenvalues).
    ``build_fmm`` adds an FMM plan of order ``fmm_p`` when ``n >= FMM_MIN_N``."""
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

    fmm_plan, overflowed = None, ()
    use_fmm = build_fmm and n >= FMM_MIN_N
    if use_fmm:
        fmm_plan = _fmm.build_plan(dc, mu_full, p=fmm_p, src_valid=roots.valid,
                                   tgt_valid=roots.valid, tgt_anchor=roots.anchor,
                                   tgt_tau=roots.tau)
        overflowed = tuple(torch.nonzero(fmm_plan.overflow).flatten().tolist())
        if overflowed:
            _fmm.OVERFLOWED.append(overflowed)
    return EighUpdatePlan(
        sort_idx=sort_idx, givens_a=defl.givens_a, givens_b=defl.givens_b,
        givens_c=defl.givens_c, givens_s=defl.givens_s, any_rot=defl.any_rot,
        compact=defl.compact, dc=dc, zc=zc, rho=rho_w, zhat=zhat, mu=roots.mu,
        anchor=roots.anchor, tau=roots.tau, valid=roots.valid, colnorm=colnorm,
        mu_full=mu_full, out_sort=out_sort, fmm=fmm_plan, n=n, negated=negated,
        has_fmm=use_fmm, fmm_overflow=overflowed,
    )


def eigenvalues(plan: EighUpdatePlan):
    """Eigenvalues of ``diag(d) + rho z z^T``, ascending."""
    mu = torch.gather(plan.mu_full, 1, plan.out_sort)
    if plan.negated:
        mu = -torch.flip(mu, dims=(1,))
    return mu


def _cauchy_block(plan: EighUpdatePlan, wc, method: str):
    """``out[b, :, i] = sum_j wc[b, :, j] zhat_j / (dc_j - mu_i)``, columns
    divided by ``colnorm``."""
    wz = wc * plan.zhat[:, None, :]
    if method == "fmm" and plan.has_fmm:
        # the FMM computes sum wz / (mu_i - dc_j): the Cauchy orientation
        # flips the sign.  Members whose plan overflowed take the dense stable
        # product (the reference's lax.cond, member by member).
        out = -_fmm.fmm_apply(plan.fmm, wz)
        if plan.fmm_overflow:
            idx = torch.tensor(plan.fmm_overflow, device=wz.device)
            pick = lambda x: x.index_select(0, idx)  # noqa: E731
            dense = _cauchy.cauchy_matmul_stable(pick(wz), pick(plan.dc), pick(plan.anchor),
                                                 pick(plan.tau), src_valid=pick(plan.valid),
                                                 tgt_valid=pick(plan.valid))
            out = out.index_copy(0, idx, dense)
    elif method == "kernel":
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


def eigh_update(u, d, z, rho, *, rho_positive: bool, method: str = "direct", fmm_p: int = 20):
    """``(mu, U_new)`` for ``U diag(d) U^T + rho (Uz)(Uz)^T = U_new diag(mu) U_new^T``."""
    plan = make_plan(d, z, rho, rho_positive=rho_positive, build_fmm=(method == "fmm"),
                     fmm_p=fmm_p)
    return eigenvalues(plan), apply_update(plan, u, method=method)
