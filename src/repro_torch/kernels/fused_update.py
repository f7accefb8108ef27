"""Fused rank-1 SVD update: the whole of Algorithm 6.1 in one body.

Counterpart of ``repro.kernels.fused_update``.  Two forms of one function:

* the plain PyTorch body (``_fused_body`` / ``_fused_truncated_body``) over a
  leading batch dimension: grouped Householder merge of (near-)coincident
  poles, tiny-z deflation, anchored secular solve (``secular_iterate``),
  Loewner zhat, scaled-Cauchy columns, a stable reorder, the structural-zero
  compression of the right-hand problem and the sign fix;
* the hand-written CUDA kernels in ``csrc/fused_update.cuh`` (a thread-block
  cluster per update; ``launch_plan`` says how a batch runs), launched by
  ``fused_update_cuda`` / ``fused_update_truncated_cuda``.

``fused_update_batched`` / ``fused_update_truncated_batched`` choose by the
device of the tensors they are given: CPU tensors take the plain body, CUDA
tensors the kernel, and nothing falls back from one to the other.

Mixed precision: 16-bit storage (bf16, f16) is computed in float32 and the
outputs are cast back; ``BF16_ERROR_BUDGET`` is the documented error budget.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.secular_body import secular_iterate

__all__ = [
    "BF16_ERROR_BUDGET",
    "FUSED_VMEM_BUDGET",
    "fused_supported",
    "fused_update_batched",
    "fused_update_truncated_batched",
    "fused_update_cuda",
    "fused_update_truncated_cuda",
    "launch_plan",
]

# The reference's working-set budget for the fused body (a TPU core's VMEM
# share).  It is kept, with the reference's formula below, as the ROUTING
# RULE of ``method="auto"`` so that both packages pick the same route for the
# same geometry; it is not a property of the H100.  Re-deriving the gate for
# this card waits for measured times.
FUSED_VMEM_BUDGET = 8 * 1024 * 1024

# bf16-storage error budget against an f64 dense reference (copied from the
# reference package, where it is pinned by its tests).
BF16_ERROR_BUDGET = {
    "sigma_rel": 5e-2,        # max_i |s_i - s_ref_i| / s_ref_0, single update
    "recon_rel": 8e-2,        # ||U S V^T - ref||_F / ||ref||_F, single update
    "drift_sigma_rel": 2e-1,  # sigma_rel after 8 sequential updates
}

# iteration counts the fused entry points run (the reference's entries pass
# these; the truncated body's own 28/4 default is not what runs)
N_BISECT = 16
N_NEWTON = 6


def _compute_dtype_for(storage_dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if storage_dtype.itemsize <= 2 else storage_dtype


def fused_supported(m: int, n: int, rank: int | None = None, dtype=torch.float32) -> bool:
    """Whether the fused route takes this geometry (the reference's gate).

    ``rank=None`` is the full update, otherwise the truncated one."""
    isz = _compute_dtype_for(dtype).itemsize
    if rank is None:
        if m > n:
            return False
        est = (10 * n * n + 10 * m * m + 8 * (m + n)) * isz
    else:
        k = rank + 1
        est = (10 * k * k + 4 * k * (m + n) + 8 * (m + n)) * isz
    return est <= FUSED_VMEM_BUDGET


# ---------------------------------------------------------------------------
# plain body
# ---------------------------------------------------------------------------


def _mv(mat, vec):
    return (mat @ vec[:, :, None])[:, :, 0]


def _mtv(mat, vec):
    return (mat.transpose(1, 2) @ vec[:, :, None])[:, :, 0]


def _flip2(x):
    return torch.flip(x, dims=(1, 2))


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=1))


def _phase(d, z, rho, *, rtol, n_bisect, n_newton):
    """Eigen-update of ``diag(d) + rho z z^T`` (d ascending, rho > 0), batched.

    Returns ``(mu_sorted, phi)``: ascending eigenvalues (B, k) and the dense
    (B, k, k) rotation with eigenvector columns in that order."""
    bsz, k = d.shape
    dt = d.dtype
    fi = torch.finfo(dt)
    rtol_v = 64.0 * fi.eps if rtol is None else rtol
    dev = d.device
    idx = torch.arange(k, device=dev)
    row, col = idx[:, None], idx[None, :]
    eye = torch.eye(k, dtype=dt, device=dev)
    rho_ = rho[:, None]

    z2_raw = z * z
    scale = torch.maximum(torch.amax(torch.abs(d), dim=1), rho * torch.sum(z2_raw, dim=1)) + fi.tiny
    tol = (rtol_v * scale)[:, None]

    # group (near-)coincident poles: leader = first pole within the gap tol,
    # chains closed by pointer jumping
    ok = (col <= row) & ((d[:, :, None] - d[:, None, :]) <= tol[:, :, None])
    leader = torch.amin(torch.where(ok, col, k), dim=2)
    for _ in range(max(1, math.ceil(math.log2(max(k, 2))))):
        leader = torch.gather(leader, 1, leader)

    # grouped Householder merge: H z|_g = r e_rep for each group
    same = leader[:, :, None] == leader[:, None, :]
    sf = same.to(dt)
    is_rep = (leader == idx).to(dt)
    gz2 = _mv(sf, z2_raw)
    z_rep = _mv(sf, z * is_rep)
    sgn = torch.where(z_rep < 0.0, 1.0, -1.0).to(dt)
    r_vec = sgn * torch.sqrt(gz2)
    wv = z - r_vec * is_rep
    gn2 = _mv(sf, wv * wv)
    denom = torch.where(gn2 > 0.0, gn2, 1.0)
    hh = eye - torch.where(same & (gn2 > 0.0)[:, :, None],
                           2.0 * wv[:, :, None] * wv[:, None, :] / denom[:, :, None], 0.0)
    z_m = r_vec * is_rep

    # tiny-z deflation on the merged weights
    z2 = z_m * z_m
    keep = rho_ * z2 > tol
    z2k = torch.where(keep, z2, 0.0)
    zn2 = torch.sum(z2k, dim=1, keepdim=True)

    # brackets: (d_i, next kept pole); the last kept gets d_i + rho ||z||^2
    big = fi.max * 0.25
    cand = torch.where((col > row) & keep[:, None, :], d[:, None, :].expand(bsz, k, k), big)
    nxt = torch.amin(cand, dim=2)
    is_last = keep & (nxt >= 0.5 * big)
    right = torch.where(is_last, d + rho_ * zn2, nxt)
    left = d
    width = torch.where(keep, right - left, 0.0)

    # anchor by the sign of w at the midpoint
    delta_mid = (d[:, None, :] - left[:, :, None]) - (0.5 * width)[:, :, None]
    safe_mid = torch.where(delta_mid == 0.0, 1.0, delta_mid)
    inv_mid = torch.where(delta_mid != 0.0, 1.0 / safe_mid, 0.0)
    w_mid = 1.0 + rho_ * torch.sum(z2k[:, None, :] * inv_mid, dim=2)
    use_left = (w_mid > 0.0) | is_last
    anchor = torch.where(use_left, left, right)
    lo = torch.where(use_left, 0.0, -0.5 * width)
    hi = torch.where(is_last, width, torch.where(use_left, 0.5 * width, 0.0))

    diff = d[:, None, :] - anchor[:, :, None]            # (roots, poles)
    tau = secular_iterate(diff, z2k, rho, lo, hi, n_bisect=n_bisect,
                          n_newton=n_newton, poles_axis=1)
    tau = torch.where(keep, tau, 0.0)
    mu = torch.where(keep, anchor + tau, d)

    # Loewner zhat in log-magnitude space, anchored differences
    delta_md = (anchor[:, :, None] - d[:, None, :]) + tau[:, :, None]
    num = torch.where(keep[:, :, None], delta_md, 1.0)
    log_num = torch.sum(torch.log(torch.abs(num) + fi.tiny), dim=1)
    dd = d[:, :, None] - d[:, None, :]
    den = torch.where((row != col) & keep[:, :, None], dd, 1.0)
    log_den = torch.sum(torch.log(torch.abs(den) + fi.tiny), dim=1)
    log_zhat2 = log_num - log_den - torch.log(rho)[:, None]
    zhat = torch.where(keep, torch.sign(z_m) * torch.exp(0.5 * log_zhat2), 0.0)

    # scaled-Cauchy eigenvector columns; deflated columns pass through
    cden = (diff - tau[:, :, None]).transpose(1, 2)      # [j, i] = d_j - mu_i
    safe = torch.where(cden == 0.0, 1.0, cden)
    invc = torch.where(cden != 0.0, 1.0 / safe, 0.0)
    nrm2 = torch.sum((zhat * zhat)[:, :, None] * invc * invc, dim=1)
    colnorm = torch.where(keep, torch.sqrt(nrm2), 1.0)
    qt = torch.where(keep[:, None, :], zhat[:, :, None] * invc / colnorm[:, None, :], eye)

    # stable rank of mu; column i of hh @ qt goes to column rank_i
    lt = (mu[:, None, :] < mu[:, :, None]).sum(2)
    eq = ((mu[:, None, :] == mu[:, :, None]) & (col < row)).sum(2)
    rank = lt + eq
    mu_sorted = torch.empty_like(mu).scatter_(1, rank, mu)
    hq = hh @ qt
    phi = torch.empty_like(hq).scatter_(2, rank[:, None, :].expand(bsz, k, k), hq)
    return mu_sorted, phi


def _chain(d0_asc, z1, z2w, rho_pos, rho_neg, *, rtol, n_bisect, n_newton):
    """Two chained phases in ascending coordinates; the rho < 0 phase solves the
    negated problem, a double flip.  Returns final ascending eigenvalues and G
    with ``Q_final = Q0_asc @ G``."""
    kw = dict(rtol=rtol, n_bisect=n_bisect, n_newton=n_newton)
    mu1, phi1 = _phase(d0_asc, z1, rho_pos, **kw)
    z2 = _mtv(phi1, z2w)
    mu_b, phi_b = _phase(torch.flip(-mu1, dims=(1,)), torch.flip(z2, dims=(1,)), -rho_neg, **kw)
    return torch.flip(-mu_b, dims=(1,)), phi1 @ _flip2(phi_b)


def _split(c):
    h = 0.5 * c
    r = torch.sqrt(h * h + 1.0)
    rho_p, rho_n = h + r, h - r
    np_ = torch.sqrt(1.0 + rho_p * rho_p)
    nn_ = torch.sqrt(1.0 + rho_n * rho_n)
    return rho_p, rho_n, ((rho_p / np_)[:, None], (1.0 / np_)[:, None]), \
        ((rho_n / nn_)[:, None], (1.0 / nn_)[:, None])


def _fused_body(u, s, v, a, b, *, sign_fix=True, deflate_rtol=None,
                n_bisect=N_BISECT, n_newton=N_NEWTON, compute_dtype=None):
    """B full rank-1 SVD updates: ``u`` (B, m, m), ``s`` (B, m), ``v`` (B, n, n),
    ``a`` (B, m), ``b`` (B, n) -> ``(u, s, v, d_left, d_right)``, descending."""
    m = u.shape[1]
    n = v.shape[1]
    store_dt = u.dtype
    cdt = compute_dtype if compute_dtype is not None else _compute_dtype_for(store_dt)
    u, s, v, a, b = (x.to(cdt) for x in (u, s, v, a, b))
    bsz = u.shape[0]
    dev = u.device
    kw = dict(rtol=deflate_rtol, n_bisect=n_bisect, n_newton=n_newton)
    flip1 = lambda x: torch.flip(x, dims=(1,))  # noqa: E731

    # STEP 1: structured products
    vtb = _mtv(v, b)
    b_t = _mv(u, s * vtb[:, :m])
    uta = _mtv(u, a)
    a_t = _mv(v[:, :, :m], s * uta)
    beta = torch.sum(b * b, dim=1)
    alpha = torch.sum(a * a, dim=1)

    # STEPS 2-3: analytic 2x2 splits
    rho1, rho2, qp, qn = _split(beta)
    a1 = qp[0] * a + qp[1] * b_t
    b1 = qn[0] * a + qn[1] * b_t
    rho3, rho4, qpv, qnv = _split(alpha)
    a2 = qpv[0] * b + qpv[1] * a_t
    b2 = qnv[0] * b + qnv[1] * a_t

    # STEPS 4-7: s^2 is descending, so ascending order is a static flip
    d_left_asc, g_u_asc = _chain(flip1(s * s), flip1(_mtv(u, a1)), flip1(_mtv(u, b1)),
                                 rho1, rho2, **kw)
    va2 = _mtv(v, a2)
    vb2 = _mtv(v, b2)

    g_u = _flip2(g_u_asc)
    d_left = flip1(d_left_asc)
    s_n = torch.sqrt(torch.clamp(d_left, min=0.0))
    u_n = u @ g_u

    if n - m > 2:
        # Structural-zero compression: the update excites only a 2-dim slice
        # of the n - m null directions; two Householders M bring it to the
        # leading coordinates, the chain runs on m + 2 coordinates and the
        # other null directions pass through with eigenvalue 0.
        k0 = n - m
        c1 = va2[:, m:]
        c2 = vb2[:, m:]
        fi = torch.finfo(cdt)
        idx0 = torch.arange(k0, device=dev)
        e1 = (idx0 == 0).to(cdt).expand(bsz, k0)
        e2 = (idx0 == 1).to(cdt).expand(bsz, k0)

        na2 = _norm(va2)[:, None]
        r11 = _norm(c1)[:, None]
        q1 = torch.where(r11 > fi.eps * na2, c1, e1)
        q1 = q1 / _norm(q1)[:, None]
        c2p = c2 - torch.sum(q1 * c2, dim=1, keepdim=True) * q1
        r22 = _norm(c2p)[:, None]
        nb2 = _norm(vb2)[:, None]
        f1 = e1 - q1 * q1[:, 0:1]
        f2 = e2 - q1 * q1[:, 1:2]
        fb = torch.where((torch.sum(f1 * f1, dim=1) >= torch.sum(f2 * f2, dim=1))[:, None], f1, f2)
        q2 = torch.where(r22 > fi.eps * (na2 + nb2), c2p, fb)
        q2 = q2 - torch.sum(q1 * q2, dim=1, keepdim=True) * q1
        q2 = q2 / _norm(q2)[:, None]

        eye0 = torch.eye(k0, dtype=cdt, device=dev)
        sgn1 = torch.where(q1[:, 0:1] >= 0.0, 1.0, -1.0).to(cdt)
        w1 = q1 + sgn1 * e1
        h1 = eye0 - (2.0 / torch.sum(w1 * w1, dim=1))[:, None, None] * (w1[:, :, None] * w1[:, None, :])
        q2h = _mv(h1, q2) * (1.0 - e1)
        q2h = q2h / torch.sqrt(torch.clamp(torch.sum(q2h * q2h, dim=1), min=fi.tiny))[:, None]
        sgn2 = torch.where(q2h[:, 1:2] >= 0.0, 1.0, -1.0).to(cdt)
        w2 = q2h + sgn2 * e2
        h2 = eye0 - (2.0 / torch.sum(w2 * w2, dim=1))[:, None, None] * (w2[:, :, None] * w2[:, None, :])
        mq = h1 @ h2
        m2 = mq[:, :, :2]

        zeros2 = torch.zeros((bsz, 2), dtype=cdt, device=dev)
        d0v = torch.cat([zeros2, flip1(s * s)], dim=1)
        z1v = torch.cat([_mtv(m2, c1), flip1(va2[:, :m])], dim=1)
        z2v = torch.cat([_mtv(m2, c2), flip1(vb2[:, :m])], dim=1)
        d_act_asc, g_act = _chain(d0v, z1v, z2v, rho3, rho4, **kw)

        v_null = v[:, :, m:]
        v_act = torch.cat([v_null @ m2, torch.flip(v[:, :, :m], dims=(2,))], dim=2)
        v_rot = v_act @ g_act
        v_inert = v_null @ mq[:, :, 2:]
        v_n = torch.cat([torch.flip(v_rot, dims=(2,)), v_inert], dim=2)
        d_right = torch.cat([flip1(d_act_asc),
                             torch.zeros((bsz, k0 - 2), dtype=cdt, device=dev)], dim=1)
        gv_mm = _flip2(g_act[:, 2:, :])[:, :, :m]
        btva = torch.cat([_mtv(m2, vtb[:, m:]), flip1(vtb[:, :m])], dim=1)
        bv = flip1(_mtv(g_act, btva))[:, :m]
    else:
        d0v = flip1(torch.cat([s * s, torch.zeros((bsz, n - m), dtype=cdt, device=dev)], dim=1))
        d_right_asc, g_v_asc = _chain(d0v, flip1(va2), flip1(vb2), rho3, rho4, **kw)
        g_v = _flip2(g_v_asc)
        d_right = flip1(d_right_asc)
        v_n = v @ g_v
        gv_mm = g_v[:, :m, :m]
        bv = _mtv(g_v[:, :, :m], vtb)

    if sign_fix:
        core = torch.sum((s[:, :, None] * g_u) * gv_mm, dim=1)
        au = _mtv(g_u, uta)
        flip = torch.where(core + au * bv < 0.0, -1.0, 1.0).to(cdt)
        v_n = torch.cat([v_n[:, :, :m] * flip[:, None, :], v_n[:, :, m:]], dim=2)

    return tuple(x.to(store_dt) for x in (u_n, s_n, v_n, d_left, d_right))


def _fused_truncated_body(u, s, v, a, b, *, deflate_rtol=None, n_bisect=N_BISECT,
                          n_newton=N_NEWTON, compute_dtype=None):
    """Brand augmentation around the fused core: ``u`` (B, m, r), ``s`` (B, r),
    ``v`` (B, n, r) -> the same shapes."""
    bsz, m, r = u.shape
    store_dt = u.dtype
    cdt = compute_dtype if compute_dtype is not None else _compute_dtype_for(store_dt)
    uc, sc, vc, ac, bc = (x.to(cdt) for x in (u, s, v, a, b))

    def _residual(basis, x):
        p = _mtv(basis, x)
        perp = x - _mv(basis, p)
        nrm = _norm(perp)
        ok = nrm > 1e-12
        unit = torch.where(ok[:, None], perp / torch.where(ok, nrm, 1.0)[:, None], 0.0)
        return p, unit, torch.where(ok, nrm, 0.0)

    p_vec, p_unit, ra = _residual(uc, ac)
    q_vec, q_unit, rb = _residual(vc, bc)
    s_aug = torch.cat([sc, torch.zeros((bsz, 1), dtype=cdt, device=u.device)], dim=1)
    ak = torch.cat([p_vec, ra[:, None]], dim=1)
    bk = torch.cat([q_vec, rb[:, None]], dim=1)
    eye = torch.eye(r + 1, dtype=cdt, device=u.device).expand(bsz, r + 1, r + 1)
    uu, ss, vv, _, _ = _fused_body(eye, s_aug, eye, ak, bk, sign_fix=True,
                                   deflate_rtol=deflate_rtol, n_bisect=n_bisect,
                                   n_newton=n_newton, compute_dtype=cdt)
    u_new = torch.cat([uc, p_unit[:, :, None]], dim=2) @ uu[:, :, :r]
    v_new = torch.cat([vc, q_unit[:, :, None]], dim=2) @ vv[:, :, :r]
    return u_new.to(store_dt), ss[:, :r].to(store_dt), v_new.to(store_dt)


# ---------------------------------------------------------------------------
# CUDA kernels A and B (csrc/fused_update.cuh)
# ---------------------------------------------------------------------------

_SUFFIX = {  # (storage, compute) -> name suffix of the extern "C" entry
    (torch.float32, torch.float32): "f32",
    (torch.float64, torch.float64): "f64",
    (torch.bfloat16, torch.float32): "bf16",
    (torch.float16, torch.float32): "f16",
}


_ENTRY_POINTS: dict = {}


def _entry(suffix: str, name: str):
    """The entry point ``name`` of library ``fused_update_<suffix>``, looked up once."""
    fn = _ENTRY_POINTS.get((suffix, name))
    if fn is None:
        fn = _ENTRY_POINTS[(suffix, name)] = getattr(_build.library(f"fused_update_{suffix}"), name)
    return fn


_TIERS = ("shared", "distributed shared", "scratch")
_DEFAULT_RTOL = {dt: 64.0 * torch.finfo(dt).eps for dt in (torch.float32, torch.float64)}


@functools.lru_cache(maxsize=512)
def _scratch_elems(suffix: str, bsz: int, m: int, n: int, r: int | None) -> int:
    """Scratch elements of a launch; raises for a shape the kernels cannot take."""
    launch_plan(suffix, bsz, m, n, r)
    if r is None:
        return _entry(suffix, "fused_full_scratch_elems")(bsz, m, n)
    return _entry(suffix, "fused_trunc_scratch_elems")(bsz, m, n, r)


@functools.lru_cache(maxsize=512)
def launch_plan(suffix: str, bsz: int, m: int, n: int, r: int | None = None) -> dict:
    """How kernel A (``r=None``) or B runs ``bsz`` updates: blocks an update
    (the cluster size), where the operators and the vectors live, a block's
    shared memory and the scratch elements.  Raises ``ValueError`` for a shape
    the kernels cannot take (what a block must keep in shared memory exceeds
    it)."""
    out = (ctypes.c_longlong * 5)()
    err = _entry(suffix, "fused_plan")(0 if r is None else 1, bsz, m, n, r or 0, out)
    if err:
        raise ValueError(f"the fused kernels cannot take m={m} n={n} r={r}: a block would need "
                         f"{out[2]} bytes of shared memory")
    return {"cluster": int(out[0]), "operators": _TIERS[out[1]],
            "vectors": "scratch" if out[4] else "shared", "smem_bytes": int(out[2]),
            "scratch_elems": int(out[3])}


def _kernel_args(u, s, v, a, b, compute_dtype, deflate_rtol):
    store = u.dtype
    cdt = compute_dtype if compute_dtype is not None else _compute_dtype_for(store)
    suffix = _SUFFIX.get((store, cdt))
    if suffix is None:
        raise NotImplementedError(
            f"the fused CUDA kernels take f32, f64, bf16 and f16 storage computed in "
            f"f32/f64; got storage {store} computed in {cdt}")
    for name, x in zip("usvab", (u, s, v, a, b)):
        if not x.is_cuda or x.dtype != store or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous CUDA {store} tensor; got "
                             f"{x.dtype} on {x.device}, contiguous={x.is_contiguous()}")
    rtol = _DEFAULT_RTOL[cdt] if deflate_rtol is None else float(deflate_rtol)
    return suffix, cdt, rtol


def _scratch(suffix, cdt, device, bsz, m, n, r=None):
    elems = _scratch_elems(suffix, bsz, m, n, r)
    return torch.empty(elems, dtype=cdt, device=device) if elems else None


def fused_update_cuda(u, s, v, a, b, *, sign_fix=True, deflate_rtol=None,
                      n_bisect=N_BISECT, n_newton=N_NEWTON, compute_dtype=None):
    """Kernel A: B full updates, a thread-block cluster each (``launch_plan``).

    The launch is asynchronous on the current stream.  A scratch tensor (only
    where the operators do not fit in shared memory) may be freed when this
    returns: PyTorch's caching allocator hands its memory only to later work
    on the same stream, which runs after the kernel."""
    suffix, cdt, rtol = _kernel_args(u, s, v, a, b, compute_dtype, deflate_rtol)
    bsz, m, _ = u.shape
    n = v.shape[1]
    if u.shape != (bsz, m, m) or s.shape != (bsz, m) or v.shape != (bsz, n, n) \
            or a.shape != (bsz, m) or b.shape != (bsz, n) or m > n:
        raise ValueError(f"bad full-update shapes u{tuple(u.shape)} s{tuple(s.shape)} "
                         f"v{tuple(v.shape)} a{tuple(a.shape)} b{tuple(b.shape)}")
    scratch = _scratch(suffix, cdt, u.device, bsz, m, n)
    outs = [torch.empty_like(u), torch.empty_like(s), torch.empty_like(v),
            torch.empty_like(s), torch.empty_like(b)]
    _build.LAUNCHES["fused_update"] += 1
    _build.check(_entry(suffix, f"fused_update_{suffix}")(
        u.data_ptr(), s.data_ptr(), v.data_ptr(), a.data_ptr(), b.data_ptr(),
        *(o.data_ptr() for o in outs), 0 if scratch is None else scratch.data_ptr(), bsz, m, n,
        rtol, n_bisect, n_newton, int(sign_fix), _build.stream()), "fused_update")
    return tuple(outs)


def fused_update_truncated_cuda(u, s, v, a, b, *, deflate_rtol=None, n_bisect=N_BISECT,
                                n_newton=N_NEWTON, compute_dtype=None):
    """Kernel B: B Brand-truncated updates, a thread-block cluster each."""
    suffix, cdt, rtol = _kernel_args(u, s, v, a, b, compute_dtype, deflate_rtol)
    bsz, m, r = u.shape
    n = v.shape[1]
    if s.shape != (bsz, r) or v.shape != (bsz, n, r) or a.shape != (bsz, m) \
            or b.shape != (bsz, n):
        raise ValueError(f"bad truncated-update shapes u{tuple(u.shape)} s{tuple(s.shape)} "
                         f"v{tuple(v.shape)} a{tuple(a.shape)} b{tuple(b.shape)}")
    scratch = _scratch(suffix, cdt, u.device, bsz, m, n, r)
    outs = [torch.empty_like(u), torch.empty_like(s), torch.empty_like(v)]
    _build.LAUNCHES["fused_update_truncated"] += 1
    _build.check(_entry(suffix, f"fused_update_truncated_{suffix}")(
        u.data_ptr(), s.data_ptr(), v.data_ptr(), a.data_ptr(), b.data_ptr(),
        *(o.data_ptr() for o in outs), 0 if scratch is None else scratch.data_ptr(), bsz, m, n,
        r, rtol, n_bisect, n_newton, _build.stream()), "fused_update_truncated")
    return tuple(outs)


def fused_update_batched(u, s, v, a, b, *, sign_fix=True, deflate_rtol=None,
                         n_bisect=N_BISECT, n_newton=N_NEWTON, compute_dtype=None):
    """B stacked full updates: the plain body for CPU tensors, kernel A for CUDA
    tensors (which raises rather than fall back)."""
    kw = dict(deflate_rtol=deflate_rtol, n_bisect=n_bisect, n_newton=n_newton,
              compute_dtype=compute_dtype)
    if u.is_cuda:
        return fused_update_cuda(u, s, v, a, b, sign_fix=sign_fix, **kw)
    return _fused_body(u, s, v, a, b, sign_fix=sign_fix, **kw)


def fused_update_truncated_batched(u, s, v, a, b, *, deflate_rtol=None, n_bisect=N_BISECT,
                                   n_newton=N_NEWTON, compute_dtype=None):
    """B stacked truncated updates: plain body on CPU tensors, kernel B on CUDA."""
    kw = dict(deflate_rtol=deflate_rtol, n_bisect=n_bisect, n_newton=n_newton,
              compute_dtype=compute_dtype)
    if u.is_cuda:
        return fused_update_truncated_cuda(u, s, v, a, b, **kw)
    return _fused_truncated_body(u, s, v, a, b, **kw)
