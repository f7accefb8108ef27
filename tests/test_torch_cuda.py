"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and ``api`` on the card going through the kernels.

They skip without a card.  The file imports neither jax nor the reference,
so it also runs on a machine that has neither:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from _torch_helpers import cuda_device, np_, spectrum_problem, svd_problem, t  # noqa: F401
from repro_torch import api, convert, updates
from repro_torch.core import fmm as FMM
from repro_torch.core import secular as SEC
from repro_torch.kernels import _build
from repro_torch.kernels import fused_update as F
from repro_torch.kernels import nearfield as NF
from repro_torch.kernels import secular_newton as SN
from repro_torch.kernels import sparse_proj as SP
from repro_torch.kernels.cauchy_matmul import cauchy_matmul_cuda, cauchy_matmul_plain

pytestmark = pytest.mark.cuda

# f64 agrees to rounding.  f32: the Cauchy product sums N terms up to
# |w| / min|den|.  The fused updates are compared by the scale-free measures
# of chip_smoke.py (see _err) on well-separated spectra, with its limits.
CAUCHY_TOL = {torch.float64: 1e-12, torch.float32: 2e-4}
# the sparse projection sums each row's terms in the plain version's order; only
# the fused multiply-add rounds differently (relative to max |out|)
SPARSE_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
FUSED_TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (1e-3, 1e-4)}
# the secular solve: max |tau - tau'| over the widest bracket (each root's
# terms summed in another order; the bisection can part where w rounds to
# either sign, by about the rounding of w over its slope)
SECULAR_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
# the near field, relative to max |out|: 3cap products summed in another order
NEAR_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _cauchy_inputs(rng, bsz, r, n, m):
    src = np.sort(rng.normal(size=(bsz, n)), axis=1)
    av = np.take_along_axis(src, rng.integers(0, n, size=(bsz, m)), axis=1)
    tau = rng.normal(size=(bsz, m)) * 1e-2
    tau[:, 0] = 0.0
    return rng.normal(size=(bsz, r, n)), src, av, tau, rng.random((bsz, m)) > 0.2


def _recon(u, s, v):
    k = s.shape[-1]
    return (u[..., :k].double() * s[..., None, :].double()) @ v[..., :, :k].double().mT


def _err(got, want):
    """(||U S V^T - U' S' V'^T||_F / ||U' S' V'^T||_F, max_i |s_i - s'_i| / s'_i),
    each the largest over the batch."""
    rw = _recon(*want[:3])
    recon = (_recon(*got[:3]) - rw).flatten(-2).norm(dim=-1) / rw.flatten(-2).norm(dim=-1)
    sw = want[1].double()
    sigma = (got[1].double() - sw).abs() / sw.abs()
    return float(recon.max()), float(sigma.max())


def _within(err, tol):
    return err[0] < tol[0] and err[1] < tol[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 5, 37, 29), (4, 192, 192, 192)])
def test_cauchy_kernel_matches_plain(cuda_device, dtype, shape):
    rng = np.random.default_rng(6)
    args = [t(x, dtype, cuda_device) for x in _cauchy_inputs(rng, *shape)]
    before = _build.LAUNCHES["cauchy_matmul"]
    got = cauchy_matmul_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["cauchy_matmul"] == before + 1
    want = cauchy_matmul_plain(*args)
    assert float((got - want).abs().max() / want.abs().max()) < CAUCHY_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(16, 16), (32, 48), (20, 21)])
def test_fused_kernel_matches_plain(cuda_device, dtype, m, n):
    rng = np.random.default_rng(31)
    probs = [spectrum_problem(rng, m, n) for _ in range(4)]
    args = [t(np.stack(x), dtype, cuda_device) for x in zip(*probs)]
    before = _build.LAUNCHES["fused_update"]
    got = F.fused_update_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_update"] == before + 1
    want = F._fused_body(*args)
    assert _within(_err(got, want), FUSED_TOL[dtype])
    flipped = got[0].clone()  # a planted fault must fail the check
    j = int(got[1][0].abs().argmin())
    flipped[0, :, j] = -flipped[0, :, j]
    assert not _within(_err((flipped,) + got[1:], want), FUSED_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_truncated_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(32)
    probs = [spectrum_problem(rng, 64, 96, 8) for _ in range(4)]
    args = [t(np.stack(x), dtype, cuda_device) for x in zip(*probs)]
    before = _build.LAUNCHES["fused_update_truncated"]
    got = F.fused_update_truncated_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_update_truncated"] == before + 1
    assert _within(_err(got, F._fused_truncated_body(*args)), FUSED_TOL[dtype])


def test_bf16_kernel_within_budget(cuda_device):
    rng = np.random.default_rng(33)
    m, n = 32, 48
    probs = [svd_problem(rng, m, n) for _ in range(8)]
    u, s, v, a, b = (np.stack(x) for x in zip(*probs))
    got = F.fused_update_cuda(*(t(x, torch.bfloat16, cuda_device) for x in (u, s, v, a, b)))
    dense = np.einsum("bik,bk,bjk->bij", u, s, v[..., :m]) + a[:, :, None] * b[:, None, :]
    s_ref = np.linalg.svd(dense, compute_uv=False)
    sigma_rel = np.max(np.abs(np_(got[1]) - s_ref).max(1) / s_ref[:, 0])
    assert sigma_rel < F.BF16_ERROR_BUDGET["sigma_rel"]


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    rng = np.random.default_rng(34)
    args = [t(np.stack(x), torch.float64, cuda_device) for x in zip(svd_problem(rng, 4, 6))]
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_update_cuda(args[0].mT, *args[1:])
    with pytest.raises(NotImplementedError):
        F.fused_update_cuda(*args, compute_dtype=torch.float32)


def test_api_on_card_goes_through_kernels(cuda_device):
    rng = np.random.default_rng(48)
    probs = [svd_problem(rng, 16, 24) for _ in range(2)]
    states = [convert.state_from_arrays(*p[:3], device=cuda_device) for p in probs]
    cpu_states = [convert.state_from_arrays(*p[:3], device="cpu") for p in probs]
    A = [p[3] for p in probs]
    B = [p[4] for p in probs]
    for method, counter in (("auto", "fused_update"), ("pallas", "cauchy_matmul")):
        before = _build.LAUNCHES[counter]
        got = api.update_many(states, A, B, api.UpdatePolicy(method=method))
        torch.cuda.synchronize()
        assert _build.LAUNCHES[counter] > before
        want = api.update_many(cpu_states, A, B, api.UpdatePolicy(method=method))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np_(g.s), np_(w.s), atol=1e-10, rtol=0)
            np.testing.assert_allclose(np_(_recon(g.u, g.s, g.v)), np_(_recon(w.u, w.s, w.v)),
                                       atol=1e-10, rtol=0)


def _sparse_inputs(rng, bsz, m, n, nnz, k, shared):
    """COO entries with duplicates, padding entries and empty rows."""
    lead = () if bsz is None else (bsz,)
    coord_lead = () if shared else lead
    rows = rng.integers(0, m // 2, coord_lead + (nnz,)).astype(np.int32)   # upper rows only
    cols = rng.integers(0, n, coord_lead + (nnz,)).astype(np.int32)
    rows[..., 1], cols[..., 1] = rows[..., 0], cols[..., 0]
    rows[..., -3:], cols[..., -3:] = 0, 0
    vals = rng.normal(size=lead + (nnz,))
    vals[..., -3:] = 0.0
    return rows, cols, vals, rng.normal(size=lead + (n, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["single", "batched", "shared_coords", "transposed",
                                  "shared_mat", "shared_mat_transposed"])
def test_sparse_kernel_matches_plain(cuda_device, dtype, case):
    """``shared_mat*``: the sketch's layout (per-member coordinates and values,
    one test matrix for the whole batch, read at batch stride 0) at the
    (32, 48) full-state drive's shape, for S @ Omega and S^T @ Psi."""
    rng = np.random.default_rng(35)
    m, n, nnz, k = 96, 80, 700, 16
    bsz = None if case in ("single", "transposed") else 4
    if case.startswith("shared_mat"):
        m, n, nnz, bsz = 32, 48, 96, 128
    rows, cols, vals, mat = _sparse_inputs(rng, bsz, m, n, nnz, k, case == "shared_coords")
    out_rows = m
    if case.startswith("shared_mat"):
        mat = rng.normal(size=(n, k))
    if case.endswith("transposed"):  # S^T @ mat: mat has m rows, out n
        rows, cols, out_rows = cols, rows, n
        mat = rng.normal(size=(m, k))
    SP.check_coords(rows, cols, out_rows, mat.shape[-2])
    args = (torch.as_tensor(rows, device=cuda_device), torch.as_tensor(cols, device=cuda_device),
            t(vals, dtype, cuda_device), t(mat, dtype, cuda_device))
    before = _build.LAUNCHES["sparse_project"]
    got = SP.sparse_project(*args, out_rows)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sparse_project"] == before + 1
    want = SP.sparse_project_plain(*args, out_rows)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) <= SPARSE_TOL[dtype]
    assert torch.equal(got, SP.sparse_project(*args, out_rows))        # no atomics
    if not case.endswith("transposed"):
        assert float(got[..., m // 2:, :].abs().max()) == 0.0            # empty rows


def test_sparse_apply_on_card_goes_through_kernel_f(cuda_device):
    rng = np.random.default_rng(36)
    probs = [svd_problem(rng, 16, 24) for _ in range(2)]
    states = [convert.state_from_arrays(*p[:3], device=cuda_device) for p in probs]
    rows = np.array([1, 1, 5, 5, 9], np.int32)
    cols = np.array([0, 3, 3, 7, 20], np.int32)
    ops = [updates.Sparse(rows, cols, rng.normal(size=5), rank=3) for _ in probs]
    before = _build.LAUNCHES["sparse_project"]
    got = api.apply_many(states, ops)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sparse_project"] == before + 2 * len(ops)
    for g, p, op in zip(got, probs, ops):
        dense = op.apply_dense((p[0] * p[1]) @ p[2][:, :16].T).numpy()
        np.testing.assert_allclose(np_(_recon(g.u, g.s, g.v)), dense, atol=1e-10, rtol=0)


def test_sparse_kernel_refuses_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(37)
    rows, cols, vals, mat = _sparse_inputs(rng, None, 8, 6, 10, 2, True)
    r, c = torch.as_tensor(rows, device=cuda_device), torch.as_tensor(cols, device=cuda_device)
    with pytest.raises(NotImplementedError, match="f32 or f64"):
        SP.sparse_project(r, c, t(vals, torch.bfloat16, cuda_device),
                          t(mat, torch.bfloat16, cuda_device), 8)
    with pytest.raises(ValueError, match="mat: expected a CUDA tensor"):
        SP.sparse_project(r, c, t(vals, torch.float64, cuda_device), t(mat), 8)
    with pytest.raises(ValueError, match="rows: expected CUDA"):
        SP.sparse_project(torch.as_tensor(rows), c, t(vals, torch.float64, cuda_device),
                          t(mat, torch.float64, cuda_device), 8)


def _secular_random(rng, bsz, n, m):
    """``tests/test_kernels.py``'s brackets: poles in [0, 5], weights in
    [0.01, 1], rho 0.7, brackets [0, width], width in [0.01, 0.5]."""
    return (np.sort(rng.uniform(0, 5, (bsz, n)), axis=1), rng.uniform(0.01, 1, (bsz, n)),
            np.full(bsz, 0.7), np.sort(rng.uniform(0, 5, (bsz, m)), axis=1), np.zeros((bsz, m)),
            rng.uniform(0.01, 0.5, (bsz, m)))


def _secular_check(args, n_bisect=58, n_newton=4):
    before = _build.LAUNCHES["secular_solve"]
    got = SN.secular_solve_cuda(*args, n_bisect=n_bisect, n_newton=n_newton)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["secular_solve"] == before + 1
    want = SN.secular_solve_plain(*args, n_bisect=n_bisect, n_newton=n_newton)
    width = float((args[5] - args[4]).abs().max())
    assert float((got - want).abs().max()) / width <= SECULAR_TOL[args[0].dtype]
    assert torch.equal(got, SN.secular_solve_cuda(*args, n_bisect=n_bisect, n_newton=n_newton))
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bsz,n,m", [(1, 50, 50), (3, 333, 150), (2, 37, 45), (2, 2500, 19)])
def test_secular_kernel_matches_plain(cuda_device, dtype, bsz, n, m):
    """Ragged root counts (not a multiple of the block's 8 warps) and, at
    N = 2500, more poles than the block stages at once."""
    rng = np.random.default_rng(n + m)
    _secular_check([t(x, dtype, cuda_device) for x in _secular_random(rng, bsz, n, m)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_secular_kernel_on_real_brackets(cuda_device, dtype):
    """Brackets as ``core.secular`` builds them from a real (d, z, rho), with
    roots hugging their poles, at the default and the fused route's step
    counts; a root with the bracket [0, 0] comes out 0."""
    rng = np.random.default_rng(61)
    n = 300
    d = np.sort(rng.uniform(1, 9, (2, n)) ** 2, axis=1)
    z = rng.normal(size=(2, n))
    z[:, ::9] *= 1e-4
    br = SEC.secular_brackets(t(d, dtype, cuda_device), t(z, dtype, cuda_device),
                              t([0.9, 1.7], dtype, cuda_device),
                              torch.tensor([n, n], device=cuda_device))
    lo, hi = br.lo.clone(), br.hi.clone()
    lo[1, 5] = hi[1, 5] = 0.0
    args = [t(d, dtype, cuda_device), br.zc2, t([0.9, 1.7], dtype, cuda_device),
            br.anchor_vals, lo, hi]
    for steps in ((58, 4), (16, 6)):
        got = _secular_check(args, *steps)
        assert float(got[1, 5]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 5, 4, 12, 6), (2, 37, 3, 45, 29), (3, 70, 5, 100, 33)])
def test_nearfield_kernel_matches_plain(cuda_device, dtype, shape):
    """Ragged rows, sources and targets (not multiples of the 32 x 32 tile),
    zeroed source slots, masked targets and one exact zero denominator."""
    bsz, r, nb, c3, capt = shape
    rng = np.random.default_rng(r * c3)
    w = rng.normal(size=(bsz, r, nb, c3))
    w[:, :, :, -3:] = 0.0
    x = rng.uniform(0, 1, (bsz, nb, c3))
    av = rng.uniform(0, 1, (bsz, nb, capt))
    tau = rng.normal(size=(bsz, nb, capt)) * 1e-4
    x[0, 0, 1], tau[0, 0, 0] = av[0, 0, 0], 0.0
    args = [t(v, dtype, cuda_device) for v in (w, x, av, tau)]
    args.append(torch.as_tensor(rng.uniform(size=(bsz, nb, capt)) > 0.2, device=cuda_device))
    before = _build.LAUNCHES["nearfield"]
    got = NF.nearfield_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["nearfield"] == before + 1
    want = NF.nearfield_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) <= NEAR_TOL[dtype]
    assert torch.equal(got, NF.nearfield_cuda(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nearfield_kernel_on_an_fmm_plan(cuda_device, dtype):
    """The operands an anchored FMM plan gives the kernel (padded box slots,
    near-pole targets)."""
    rng = np.random.default_rng(62)
    n = 300
    src = np.sort(rng.uniform(0, 1, (2, n)), axis=1)
    anchor = rng.integers(0, n, (2, n))
    tau = rng.normal(size=(2, n)) * 1e-7
    plan = FMM.build_plan(t(src, dtype, cuda_device),
                          t(np.take_along_axis(src, anchor, 1) + tau, dtype, cuda_device), p=16,
                          tgt_anchor=torch.as_tensor(anchor, device=cuda_device),
                          tgt_tau=t(tau, dtype, cuda_device))
    ops_ = FMM.near_operands(plan, t(rng.normal(size=(2, 7, n)), dtype, cuda_device))
    got, want = NF.nearfield_cuda(*ops_), NF.nearfield_plain(*ops_)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= NEAR_TOL[dtype]


def test_secular_and_nearfield_kernels_refuse_what_they_do_not_take(cuda_device):
    rng = np.random.default_rng(63)
    sec = _secular_random(rng, 1, 8, 5)
    with pytest.raises(ValueError, match="expected a contiguous CUDA"):
        SN.secular_solve_cuda(*(t(x) for x in sec))
    with pytest.raises(NotImplementedError, match="f32 or f64"):
        SN.secular_solve_cuda(*(t(x, torch.bfloat16, cuda_device) for x in sec))
    near = [rng.normal(size=(1, 2, 3, 6)), rng.uniform(size=(1, 3, 6)), rng.uniform(size=(1, 3, 4)),
            np.zeros((1, 3, 4)), np.ones((1, 3, 4), bool)]
    with pytest.raises(ValueError, match="expected a contiguous CUDA"):
        NF.nearfield_cuda(*(t(x) for x in near[:4]), torch.as_tensor(near[4]))
    with pytest.raises(ValueError, match="expected shape"):
        NF.nearfield_cuda(*(t(x, torch.float64, cuda_device) for x in near[:3]),
                          t(np.zeros((1, 3, 5)), torch.float64, cuda_device),
                          torch.as_tensor(near[4], device=cuda_device))


def test_fmm_update_on_card_goes_through_kernel_e(cuda_device):
    """``method="fmm"`` on the card: 8 launches of kernel E per call (four
    applies a side, both sides above the FMM floor), none of D, and the
    result of the CPU route."""
    rng = np.random.default_rng(64)
    probs = [svd_problem(rng, 128, 160) for _ in range(2)]
    states = [convert.state_from_arrays(*p[:3], device=cuda_device) for p in probs]
    cpu_states = [convert.state_from_arrays(*p[:3], device="cpu") for p in probs]
    A, B = [p[3] for p in probs], [p[4] for p in probs]
    pol = api.UpdatePolicy(method="fmm")
    before = dict(_build.LAUNCHES)
    got = api.update_many(states, A, B, pol)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["nearfield"] == before["nearfield"] + 8
    assert _build.LAUNCHES["secular_solve"] == before["secular_solve"]
    want = api.update_many(cpu_states, A, B, pol)
    for g, w in zip(got, want):
        scale = float(w.s[0])
        assert float((g.s.cpu() - w.s).abs().max()) / scale <= 1e-10
        assert float((_recon(g.u, g.s, g.v).cpu() - _recon(w.u, w.s, w.v)).abs().max()) / scale <= 1e-10
