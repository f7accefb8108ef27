"""1-D Chebyshev Fast Multipole Method for Cauchy sums (paper §5, App. D), plain PyTorch.

Counterpart of ``repro.core.fmm``.  For targets ``y`` and sources ``x`` with
weights ``w`` it evaluates

    f(y_i) = sum_j w_j / (y_i - x_j)

in O((N + M) p) per weight vector, p the Chebyshev order.  Every tensor
carries a leading batch dimension B; the static structure (``p, nlevs, nb,
cap, capt, n, m, k_out``) is shared by the batch.

* ``build_plan`` bins sources and targets by value into ``nb`` leaf boxes of
  static capacity (``cap``, ``capt``), builds the shared P2M / M2M / M2L /
  L2P operators, and peels up to ``k_out`` outlier targets and sources off
  the grid into dense rows and columns.  Clustering beyond the capacity sets
  ``overflow`` per member (the caller then takes the dense product).
* ``fmm_apply`` runs the upward and downward passes as batched matrix
  products and adds the near field: each leaf box's targets against the
  sources of boxes b-1, b, b+1, with the near-pole denominator in anchored
  form ``(av - x) + tau``.

The near field is where the routes differ.  The reference precomputes the
masked inverse blocks ``near_inv`` (nb, 3cap, capt) in its plan and contracts
against them.  Here no route stores them: ``fmm_apply`` gathers the weights
of each box's neighbourhood with the invalid slots zeroed
(``near_operands``) and hands them, with ``x_near``, ``av_b``, ``tau_b`` and
the target mask, to ``kernels.ops.nearfield``, which builds each block on
the fly: kernel E (``csrc/nearfield.cu``) for CUDA tensors, its plain
version for CPU tensors.  Both routes read the same plan fields.  Every
other pass (P2M, M2M, M2L, L2P, the outlier rows and columns) is plain
PyTorch, as the reference leaves them to XLA.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import torch

from repro_torch.core.cheb import cheb_nodes, lagrange_eval

__all__ = ["FmmPlan", "build_plan", "fmm_apply", "fmm_matvec", "fmm_error_bound",
           "near_operands"]

_M2L_OFFSETS = (-3, -2, 2, 3)

# the batch members of each plan that overflowed, one tuple per such plan, as
# ``core.eigh_update.make_plan`` finds them (one host read per plan); the last
# 256 such plans are kept, and the caller may clear it
OVERFLOWED: collections.deque = collections.deque(maxlen=256)


@dataclasses.dataclass(frozen=True)
class FmmPlan:
    src: torch.Tensor           # (B, N) source coordinates
    src_box_idx: torch.Tensor   # (B, nb, cap) indices into the sources
    src_box_mask: torch.Tensor  # (B, nb, cap) bool
    tgt_box_idx: torch.Tensor   # (B, nb, capt) indices into the targets
    tgt_box_mask: torch.Tensor  # (B, nb, capt) bool
    anterp: torch.Tensor        # (B, nb, p, cap) P2M operator per leaf box
    tgt_eval: torch.Tensor      # (B, nb, capt, p) L2P operator per leaf box
    m2m_l: torch.Tensor         # (p, p) child -> parent (left)
    m2m_r: torch.Tensor         # (p, p) child -> parent (right)
    t_hat: torch.Tensor         # (4, p, p) scale-free M2L for offsets (-3, -2, 2, 3)
    near_src_idx: torch.Tensor  # (B, nb, 3cap) sources of boxes b-1, b, b+1
    near_src_mask: torch.Tensor  # (B, nb, 3cap) bool
    x_near: torch.Tensor        # (B, nb, 3cap) their coordinates
    av_b: torch.Tensor          # (B, nb, capt) target anchor values per box
    tau_b: torch.Tensor         # (B, nb, capt) target offsets (0 when unanchored)
    out_idx: torch.Tensor       # (B, k_out) out-of-grid target indices
    out_inv: torch.Tensor       # (B, k_out, N) masked 1/(y - x) for outlier targets
    src_out_idx: torch.Tensor   # (B, k_out) out-of-bulk source indices
    src_out_inv: torch.Tensor   # (B, k_out, M) masked 1/(y - x) for outlier sources
    span: torch.Tensor          # (B,) domain scale (for level radii)
    overflow: torch.Tensor      # (B,) bool: a capacity was exceeded
    p: int
    nlevs: int
    nb: int
    cap: int
    capt: int
    n: int
    m: int
    k_out: int


def fmm_error_bound(p: int) -> float:
    """Geometric convergence bound for offset-2 separation (~(3+2sqrt2)^-p)."""
    rho = 3.0 + 2.0 * (2.0 ** 0.5)
    return 4.0 * rho ** (1 - p)


def _take(x, idx):
    """``x[b, idx[b, ...]]`` for ``x`` (B, L) and any ``idx`` (B, ...)."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).view(idx.shape)


def _inverse(denom, mask):
    """``1 / denom`` where ``mask`` and the denominator is non-zero, else 0."""
    return torch.where(mask & (denom != 0.0), 1.0 / torch.where(denom == 0.0, 1.0, denom), 0.0)


def _bin_points(x, valid, lo, width, nb: int, cap: int):
    """Static-shape value binning.  Invalid points, and points beyond a box's
    capacity, go to a spill box ``nb`` that is dropped."""
    bsz, n = x.shape
    dev = x.device
    ib = torch.clamp(torch.floor((x - lo[:, None]) / width[:, None]), 0, nb - 1).long()
    ib = torch.where(valid, ib, nb)
    order = torch.argsort(ib, dim=1, stable=True)
    ib_sorted = torch.gather(ib, 1, order)
    bins = torch.arange(nb + 1, device=dev).expand(bsz, nb + 1).contiguous()
    starts = torch.searchsorted(ib_sorted, bins, side="left")
    rank = torch.arange(n, device=dev)[None, :] - torch.gather(starts, 1, ib_sorted)
    ok = (rank < cap) & (ib_sorted < nb)
    counts = torch.zeros((bsz, nb + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, ib, torch.ones_like(ib))
    overflow = torch.any(counts[:, :nb] > cap, dim=1)

    # each (box, slot) of a real box is written by exactly one point; the
    # spill box takes the rest
    flat = torch.where(ok, ib_sorted, nb) * cap + torch.clamp(rank, 0, cap - 1)
    box_idx = torch.zeros((bsz, (nb + 1) * cap), dtype=torch.long, device=dev)
    box_mask = torch.zeros((bsz, (nb + 1) * cap), dtype=torch.bool, device=dev)
    box_idx.scatter_(1, flat, order)
    box_mask.scatter_(1, flat, ok)
    return (box_idx.view(bsz, nb + 1, cap)[:, :nb].contiguous(),
            box_mask.view(bsz, nb + 1, cap)[:, :nb].contiguous(), overflow)


def _neighbour(a, o: int):
    """``out[:, b] = a[:, b + o]`` along the box axis, zero (False) fill."""
    if o == 0:
        return a
    fill = torch.zeros_like(a[:, :abs(o)])
    if o > 0:
        return torch.cat([a[:, o:], fill], dim=1)
    return torch.cat([fill, a[:, :o]], dim=1)


def build_plan(src, tgt, *, p: int = 20, leaf_size: int | None = None, cap_factor: int = 4,
               src_valid=None, tgt_valid=None, tgt_anchor=None, tgt_tau=None) -> FmmPlan:
    """The FMM geometry and operators for sources ``src`` (B, N) and targets
    ``tgt`` (B, M).

    If ``tgt_anchor`` / ``tgt_tau`` are given, the targets are
    ``src[anchor] + tau`` and the near-field and outlier denominators take the
    cancellation-free form ``(src[anchor_i] - src_j) + tau_i``.
    """
    bsz, n = src.shape
    m = tgt.shape[1]
    dt, dev = src.dtype, src.device
    fi = torch.finfo(dt)
    if src_valid is None:
        src_valid = torch.ones((bsz, n), dtype=torch.bool, device=dev)
    if tgt_valid is None:
        tgt_valid = torch.ones((bsz, m), dtype=torch.bool, device=dev)
    if leaf_size is None:
        leaf_size = max(2 * p, 8)

    nlevs = max(2, math.ceil(math.log2(max(n, 1) / leaf_size))) if n > leaf_size else 2
    nb = 2 ** nlevs
    cap = cap_factor * max(n // nb, 1) + 8
    capt = cap_factor * max(m // nb, 1) + 8
    k_out = 8  # static cap on out-of-grid targets (and sources) handled densely

    # The grid covers the BULK of the sources: an extreme pole (a squared
    # spectrum's top eigenvalue above a cluster) and the secular roots beyond
    # it would crowd a uniform grid into one box, so both are peeled off (up
    # to k_out each) as dense rows and columns.
    lo_full = torch.where(src_valid, src, fi.max).amin(dim=1)
    hi_full = torch.where(src_valid, src, -fi.max).amax(dim=1)
    quant = torch.tensor([0.02, 0.98], dtype=dt, device=dev)
    q_lo, q_hi = torch.nanquantile(torch.where(src_valid, src, math.nan), quant, dim=1)
    bulk_span = (q_hi - q_lo) + fi.tiny
    use_bulk = (hi_full - lo_full) > 4.0 * bulk_span
    lo = torch.where(use_bulk, q_lo - 0.05 * bulk_span, lo_full)
    hi = torch.where(use_bulk, q_hi + 0.05 * bulk_span, hi_full)
    span = (hi - lo) * (1 + 16 * fi.eps) + fi.tiny
    width = span / nb

    lo_, end_ = lo[:, None], (lo + span)[:, None]
    src_in = (src >= lo_) & (src < end_)
    in_range = (tgt >= lo_) & (tgt < end_)
    sb_idx, sb_mask, ovf_s = _bin_points(src, src_valid & src_in, lo, width, nb, cap)
    tb_idx, tb_mask, ovf_t = _bin_points(tgt, tgt_valid & in_range, lo, width, nb, capt)
    anchor_vals = None if tgt_anchor is None else torch.gather(src, 1, tgt_anchor)

    # outlier targets: dense rows against all sources.  torch.topk orders the
    # -1 ties of non-outliers in its own way; their rows are zero.
    is_out = tgt_valid & ~in_range
    score = torch.where(is_out, torch.maximum(lo_ - tgt, tgt - end_), -1.0)
    out_idx = torch.topk(score, k_out, dim=1).indices
    out_mask = torch.gather(score, 1, out_idx) > 0
    if anchor_vals is not None:
        # anchored: outliers a hair past the grid edge keep full accuracy
        denom_out = ((torch.gather(anchor_vals, 1, out_idx)[:, :, None] - src[:, None, :])
                     + torch.gather(tgt_tau, 1, out_idx)[:, :, None])
    else:
        denom_out = torch.gather(tgt, 1, out_idx)[:, :, None] - src[:, None, :]
    out_inv = _inverse(denom_out, out_mask[:, :, None] & src_valid[:, None, :])

    # outlier sources: dense columns against the in-grid targets (outlier
    # targets already see every source through out_inv)
    s_is_out = src_valid & ~src_in
    s_score = torch.where(s_is_out, torch.maximum(lo_ - src, src - end_), -1.0)
    src_out_idx = torch.topk(s_score, k_out, dim=1).indices
    s_out_mask = torch.gather(s_score, 1, src_out_idx) > 0
    src_out = torch.gather(src, 1, src_out_idx)[:, :, None]
    if anchor_vals is not None:
        denom_s = (anchor_vals[:, None, :] - src_out) + tgt_tau[:, None, :]
    else:
        denom_s = tgt[:, None, :] - src_out
    src_out_inv = _inverse(denom_s, s_out_mask[:, :, None] & (tgt_valid & in_range)[:, None, :])

    overflow = (ovf_s | ovf_t | (is_out.sum(dim=1) > k_out)
                | (s_is_out.sum(dim=1) > k_out))

    t = cheb_nodes(p, dt, dev)
    centers = lo[:, None] + (torch.arange(nb, dtype=dt, device=dev) + 0.5)[None, :] * width[:, None]
    r_leaf = (0.5 * width)[:, None, None]

    # P2M anterpolation per leaf box: anterp[b, box, q, c] = u_q((x - c_box) / r)
    xhat = (_take(src, sb_idx) - centers[:, :, None]) / r_leaf
    anterp = torch.movedim(lagrange_eval(t, xhat), 0, 2) * sb_mask[:, :, None, :]
    # L2P per leaf box: tgt_eval[b, box, c, q] = u_q((y - c_box) / r)
    ys = _take(tgt, tb_idx)
    tgt_eval = torch.movedim(lagrange_eval(t, (ys - centers[:, :, None]) / r_leaf), 0, -1)
    tgt_eval = tgt_eval * tb_mask[:, :, :, None]

    # shared translation operators
    m2m_l = lagrange_eval(t, (t - 1.0) / 2.0)
    m2m_r = lagrange_eval(t, (t + 1.0) / 2.0)
    t_hat = torch.stack([1.0 / (t[:, None] - t[None, :] - 2.0 * o) for o in _M2L_OFFSETS])

    # near field: the sources of boxes b-1, b, b+1
    near_src_idx = torch.cat([_neighbour(sb_idx, o) for o in (-1, 0, 1)], dim=2)
    near_src_mask = torch.cat([_neighbour(sb_mask, o) for o in (-1, 0, 1)], dim=2)
    if anchor_vals is not None:
        av_b, tau_b = _take(anchor_vals, tb_idx), _take(tgt_tau, tb_idx)
    else:
        av_b, tau_b = ys, torch.zeros_like(ys)

    return FmmPlan(
        src=src, src_box_idx=sb_idx, src_box_mask=sb_mask, tgt_box_idx=tb_idx,
        tgt_box_mask=tb_mask, anterp=anterp, tgt_eval=tgt_eval, m2m_l=m2m_l, m2m_r=m2m_r,
        t_hat=t_hat, near_src_idx=near_src_idx, near_src_mask=near_src_mask,
        x_near=_take(src, near_src_idx), av_b=av_b, tau_b=tau_b, out_idx=out_idx,
        out_inv=out_inv, src_out_idx=src_out_idx, src_out_inv=src_out_inv, span=span,
        overflow=overflow, p=p, nlevs=nlevs, nb=nb, cap=cap, capt=capt, n=n, m=m, k_out=k_out,
    )


def _shift_boxes(w, o: int):
    """``out[..., b, :] = w[..., b + o, :]`` with zero fill."""
    if o == 0:
        return w
    fill = torch.zeros_like(w[..., :abs(o), :])
    if o > 0:
        return torch.cat([w[..., o:, :], fill], dim=-2)
    return torch.cat([fill, w[..., :o, :]], dim=-2)


def _gather_rows(w, idx):
    """``w[b, r, idx[b, ...]]`` for ``w`` (B, R, N): (B, R, *idx.shape[1:])."""
    bsz, r_dim = w.shape[:2]
    flat = idx.reshape(bsz, 1, -1).expand(bsz, r_dim, -1)
    return torch.gather(w, 2, flat).view((bsz, r_dim) + tuple(idx.shape[1:]))


def near_operands(plan: FmmPlan, w):
    """The near-field operands of ``w`` (B, R, N): ``(w_near, x_near, av_b,
    tau_b, tgt_mask)``, ``w_near`` (B, R, nb, 3cap) with the invalid source
    slots zeroed, as ``kernels.ops.nearfield`` takes them."""
    w_near = _gather_rows(w, plan.near_src_idx) * plan.near_src_mask[:, None].to(w.dtype)
    return w_near, plan.x_near, plan.av_b, plan.tau_b, plan.tgt_box_mask


def fmm_apply(plan: FmmPlan, w):
    """``f[b, r, i] = sum_j w[b, r, j] / (tgt_bi - src_bj)`` for ``w`` (B, R, N)."""
    from repro_torch.kernels import ops as _kops

    bsz, r_dim, _ = w.shape
    dt = w.dtype
    nlevs, p = plan.nlevs, plan.p

    # ---- P2M at the leaves, then upward (M2M)
    w_boxed = _gather_rows(w, plan.src_box_idx) * plan.src_box_mask[:, None].to(dt)
    mp = {nlevs: torch.einsum("zbqc,zrbc->zrbq", plan.anterp, w_boxed)}
    for lvl in range(nlevs - 1, 1, -1):
        child = mp[lvl + 1].reshape(bsz, r_dim, 2 ** lvl, 2, p)
        mp[lvl] = child[..., 0, :] @ plan.m2m_l.T + child[..., 1, :] @ plan.m2m_r.T

    # ---- downward (M2L + L2L)
    loc = None
    for lvl in range(2, nlevs + 1):
        nbl = 2 ** lvl
        if lvl > 2:
            loc = torch.stack([loc @ plan.m2m_l, loc @ plan.m2m_r], dim=3).reshape(
                bsz, r_dim, nbl, p)
        else:
            loc = torch.zeros((bsz, r_dim, nbl, p), dtype=dt, device=w.device)
        r_lvl = plan.span / (2.0 ** (lvl + 1))
        even = (torch.arange(nbl, device=w.device) % 2 == 0).to(dt)
        # even boxes take offsets {-2, +2, +3}, odd ones {-3, -2, +2}
        parity = {-3: 1.0 - even, -2: torch.ones_like(even), 2: torch.ones_like(even), 3: even}
        contrib = torch.zeros_like(loc)
        for oi, o in enumerate(_M2L_OFFSETS):
            term = _shift_boxes(mp[lvl], o) @ plan.t_hat[oi].T
            contrib = contrib + term * parity[o][:, None]
        loc = loc + contrib / r_lvl[:, None, None, None]

    # ---- leaf evaluation: far field + near field (kernel E on a card)
    f_far = torch.einsum("zbtq,zrbq->zrbt", plan.tgt_eval, loc)
    f_boxed = f_far + _kops.nearfield(*near_operands(plan, w))

    # ---- scatter back to target order: each valid target appears once,
    # masked slots add exact zeros
    out = torch.zeros((bsz, r_dim, plan.m), dtype=dt, device=w.device)
    keep = plan.tgt_box_mask.reshape(bsz, 1, -1)
    out.scatter_add_(2, plan.tgt_box_idx.reshape(bsz, 1, -1).expand(bsz, r_dim, -1),
                     torch.where(keep, f_boxed.reshape(bsz, r_dim, -1), 0.0))

    # ---- out-of-grid targets (dense rows) and out-of-bulk sources (dense columns)
    f_out = torch.einsum("zrn,zkn->zrk", w, plan.out_inv)
    out.scatter_add_(2, plan.out_idx[:, None, :].expand(bsz, r_dim, -1), f_out)
    w_sout = torch.gather(w, 2, plan.src_out_idx[:, None, :].expand(bsz, r_dim, -1))
    return out + torch.einsum("zrk,zkm->zrm", w_sout, plan.src_out_inv)


def fmm_matvec(weights, src, tgt, *, p: int = 20, **kw):
    """One-shot ``f[b, (r,) i] = sum_j weights[b, (r,) j] / (tgt_bi - src_bj)``;
    ``weights`` is (B, N) or (B, R, N)."""
    plan = build_plan(src, tgt, p=p, **kw)
    if weights.dim() == 2:
        return fmm_apply(plan, weights[:, None, :])[:, 0]
    return fmm_apply(plan, weights)
