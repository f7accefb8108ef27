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
from repro_torch.kernels.cauchy_matmul import (cauchy_matmul_cuda, cauchy_matmul_cuda_planned,
                                                cauchy_matmul_plain, cauchy_plan)

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


# Kernels A and B as launched since the cluster redesign: every operator tier,
# several cluster sizes, truncation ranks, 16-bit storage, two launches equal
# to the bit, and the shapes they refuse.  f32 at (256, 320) is held to
# chip_smoke.py's limits for that shape (its route decides its smallest
# triplets by rounding; see chip_smoke.TOL), 16-bit storage to chip_smoke's
# bf16 limits against the plain body on the same storage.
FUSED_TOL_256 = (5e-2, 2e-3)
FUSED_TOL_16BIT = (3e-3, 1e-2)


def _suffix(dtype):
    return F._SUFFIX[(dtype, F._compute_dtype_for(dtype))]


def _full_args(rng, bsz, m, n, dtype, device):
    return [t(np.stack(x), dtype, device) for x in zip(*[spectrum_problem(rng, m, n)
                                                         for _ in range(bsz)])]


def _trunc_args(rng, bsz, m, n, r, dtype, device):
    return [t(np.stack(x), dtype, device) for x in zip(*[spectrum_problem(rng, m, n, r)
                                                         for _ in range(bsz)])]


@pytest.mark.parametrize("m,n,dtype,bsz,tier", [
    (16, 16, torch.float64, 2, "distributed shared"),
    (20, 21, torch.float64, 2, "distributed shared"),
    (32, 48, torch.float64, 2, "distributed shared"),
    (100, 150, torch.float64, 2, "distributed shared"),
    (130, 200, torch.float64, 2, "scratch"),
    (256, 320, torch.float32, 2, "scratch"),
    (32, 48, torch.float64, 128, "shared"),
    (256, 320, torch.float32, 32, "scratch"),
])
def test_fused_kernel_each_operator_tier(cuda_device, m, n, dtype, bsz, tier):
    rng = np.random.default_rng(61)
    args = _full_args(rng, bsz, m, n, dtype, cuda_device)
    plan = F.launch_plan(_suffix(dtype), bsz, m, n)
    assert plan["operators"] == tier
    got = F.fused_update_cuda(*args)
    torch.cuda.synchronize()
    tol = FUSED_TOL_256 if (m, n) == (256, 320) else FUSED_TOL[dtype]
    assert _within(_err(got, F._fused_body(*args)), tol)
    assert all(bool(torch.isfinite(x).all()) for x in got)


@pytest.mark.parametrize("bsz", [1, 3, 16, 33, 128])
def test_fused_kernel_cluster_sizes(cuda_device, bsz):
    rng = np.random.default_rng(62)
    args = _full_args(rng, bsz, 32, 48, torch.float64, cuda_device)
    plan = F.launch_plan("f64", bsz, 32, 48)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    c = plan["cluster"]
    assert c in (1, 2, 4, 8) and (c == 1 or bsz * c <= sms)
    assert (c == 1) == (2 * bsz > sms)
    got = F.fused_update_cuda(*args)
    torch.cuda.synchronize()
    assert _within(_err(got, F._fused_body(*args)), FUSED_TOL[torch.float64])
    targs = _trunc_args(rng, bsz, 64, 96, 8, torch.float64, cuda_device)
    assert F.launch_plan("f64", bsz, 64, 96, 8)["cluster"] in (1, 2, 4, 8)
    tgot = F.fused_update_truncated_cuda(*targs)
    torch.cuda.synchronize()
    assert _within(_err(tgot, F._fused_truncated_body(*targs)), FUSED_TOL[torch.float64])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 16, 32, 63])
def test_fused_truncated_kernel_ranks(cuda_device, dtype, r):
    rng = np.random.default_rng(63)
    args = _trunc_args(rng, 4, 200, 300, r, dtype, cuda_device)
    got = F.fused_update_truncated_cuda(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (4, 200, r) and got[2].shape == (4, 300, r)
    assert _within(_err(got, F._fused_truncated_body(*args)), FUSED_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_kernels_16bit_storage(cuda_device, dtype):
    rng = np.random.default_rng(64)
    args = _full_args(rng, 8, 32, 48, dtype, cuda_device)
    got = F.fused_update_cuda(*args)
    targs = _trunc_args(rng, 8, 64, 96, 8, dtype, cuda_device)
    tgot = F.fused_update_truncated_cuda(*targs)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and tgot[0].dtype == dtype
    assert _within(_err(got, F._fused_body(*args)), FUSED_TOL_16BIT)
    assert _within(_err(tgot, F._fused_truncated_body(*targs)), FUSED_TOL_16BIT)


@pytest.mark.parametrize("case", ["A shared", "A distributed", "A scratch", "B r16", "B r63"])
def test_fused_kernels_two_launches_equal_to_the_bit(cuda_device, case):
    rng = np.random.default_rng(65)
    if case.startswith("A"):
        bsz, m, n, dt = {"A shared": (128, 32, 48, torch.float64),
                         "A distributed": (2, 100, 150, torch.float64),
                         "A scratch": (32, 256, 320, torch.float32)}[case]
        args = _full_args(rng, bsz, m, n, dt, cuda_device)
        fn = F.fused_update_cuda
    else:
        r = int(case[3:])
        args = _trunc_args(rng, 16, 512, 768, r, torch.float32, cuda_device)
        fn = F.fused_update_truncated_cuda
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


# Two batch sizes of the same members: a different cluster size (8 blocks an
# update at B = 1, one at 128) and, at (100, 150), another home for the
# operators (distributed shared memory, then scratch); the bits are the same.
@pytest.mark.parametrize("case", ["A (32,48) f64", "A (100,150) f64", "A (256,320) f32",
                                  "B m512 n768 r16 f32", "B m1024 n4096 r32 f64"])
def test_fused_kernels_same_bits_at_every_batch_size(cuda_device, case):
    rng = np.random.default_rng(67)
    kind, dt = case[0], torch.float64 if case.endswith("f64") else torch.float32
    if kind == "A":
        m, n = {"A (32,48) f64": (32, 48), "A (100,150) f64": (100, 150),
                "A (256,320) f32": (256, 320)}[case]
        big_b = 128 if m < 256 else 67
        args = _full_args(rng, big_b, m, n, dt, cuda_device)
        fn, plan = F.fused_update_cuda, lambda bsz: F.launch_plan(_suffix(dt), bsz, m, n)
    else:
        m, n, r = (512, 768, 16) if "m512" in case else (1024, 4096, 32)
        big_b = 128
        args = _trunc_args(rng, big_b, m, n, r, dt, cuda_device)
        fn, plan = F.fused_update_truncated_cuda, lambda bsz: F.launch_plan(_suffix(dt), bsz, m, n, r)
    assert plan(1)["cluster"] == 8 and plan(big_b)["cluster"] == 1
    whole = fn(*args)
    for bsz in (1, 3, 16):
        part = fn(*[x[:bsz].contiguous() for x in args])
        torch.cuda.synchronize()
        assert all(torch.equal(x[:bsz], y) for x, y in zip(whole, part)), bsz


# The largest shapes the fused gate passes, through api.update with the
# default policy (auto sizes the gate in f32 unless storage_dtype is set, so
# f64 states up to (323, 323) or (2, 457) take the fused route): kernel A
# takes them, past kmax ~300 in f64 with its vectors in device scratch, and
# agrees with the same update on the CPU (the plain body).
@pytest.mark.parametrize("m,n,dtype", [
    (200, 300, torch.float64), (256, 320, torch.float64), (323, 323, torch.float64),
    (2, 457, torch.float64), (323, 323, torch.float32), (2, 457, torch.float32),
])
def test_fused_kernel_takes_the_largest_gate_shapes(cuda_device, m, n, dtype):
    rng = np.random.default_rng(68)
    u, s, v, a, b = spectrum_problem(rng, m, n)
    pol = api.UpdatePolicy()
    assert pol.resolve_method(n, m=m, n=n) == "fused"
    plan = F.launch_plan(_suffix(dtype), 1, m, n)
    assert plan["vectors"] == ("scratch" if dtype == torch.float64 and max(n, m + 2) > 301
                               else "shared")
    state = convert.state_from_arrays(u, s, v, device=cuda_device, dtype=dtype)
    before = _build.LAUNCHES["fused_update"]
    got = api.update(state, t(a, dtype, cuda_device), t(b, dtype, cuda_device), pol)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_update"] == before + 1
    want = api.update(convert.state_from_arrays(u, s, v, device="cpu", dtype=dtype),
                      t(a, dtype, "cpu"), t(b, dtype, "cpu"), pol)
    tol = FUSED_TOL[dtype] if dtype == torch.float64 else FUSED_TOL_256
    assert _within(_err((got.u.cpu(), got.s.cpu(), got.v.cpu()), (want.u, want.s, want.v)), tol)


# The one-block kernels this design replaced took f64 shapes up to kmax ~490
# (their vectors in shared memory); these run, with the vectors in scratch.
@pytest.mark.parametrize("case", ["A (300,490)", "B m500 n520 r480"])
def test_fused_kernels_take_what_one_block_took(cuda_device, case):
    rng = np.random.default_rng(69)
    if case.startswith("A"):
        args = _full_args(rng, 1, 300, 490, torch.float64, cuda_device)
        assert F.launch_plan("f64", 1, 300, 490)["vectors"] == "scratch"
        got, want = F.fused_update_cuda(*args), F._fused_body(*args)
    else:
        args = _trunc_args(rng, 1, 500, 520, 480, torch.float64, cuda_device)
        assert F.launch_plan("f64", 1, 500, 520, 480)["vectors"] == "scratch"
        got, want = F.fused_update_truncated_cuda(*args), F._fused_truncated_body(*args)
    torch.cuda.synchronize()
    assert _within(_err(got, want), FUSED_TOL[torch.float64])


def test_fused_kernels_refuse_what_they_cannot_take(cuda_device):
    rng = np.random.default_rng(66)
    args = _full_args(rng, 2, 32, 48, torch.float64, cuda_device)
    before = _build.LAUNCHES["fused_update"]
    with pytest.raises(ValueError, match="shapes"):
        F.fused_update_cuda(args[2], args[1], args[0], args[3], args[4])   # m > n
    with pytest.raises(ValueError, match="shapes"):
        F.fused_update_cuda(args[0], args[1][:, :-1].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="contiguous CUDA"):
        F.fused_update_cuda(args[0].cpu(), *args[1:])
    assert _build.LAUNCHES["fused_update"] == before
    with pytest.raises(NotImplementedError):
        F.fused_update_truncated_cuda(*[x.to(torch.float16) for x in
                                        _trunc_args(rng, 2, 64, 96, 8, torch.float64, cuda_device)],
                                      compute_dtype=torch.float64)


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


def _bucket_case(rng, case):
    """(rows, cols, vals, mat, out_rows) of one bucketing case, numpy."""
    m, n, nnz, k, bsz = 96, 80, 700, 16, None
    if case == "rows32768":             # an embedding table's row count, B=2
        m, n, nnz, bsz = 32768, 64, 40000, 2
    if case == "rows70000":             # row counters beyond shared memory
        m, n, nnz = 70000, 64, 5000
    if case == "per_member":
        bsz = 3
    if case == "nnz0":
        nnz = 0
    rows = rng.integers(0, m - 5, (() if bsz is None or case != "per_member" else (bsz,))
                        + (nnz,)).astype(np.int32)          # the last 5 rows stay empty
    if case == "one_row_256":
        rows[rng.choice(nnz, 256, replace=False)] = 7
    if case == "all_in_one_row":
        rows[:] = 11
    cols = rng.integers(0, n, rows.shape).astype(np.int32)
    lead = () if bsz is None else (bsz,)
    return rows, cols, rng.normal(size=lead + (nnz,)), rng.normal(size=lead + (n, k)), m


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["spread", "one_row_256", "nnz0", "all_in_one_row", "rows32768",
                                  "rows70000", "per_member"])
def test_sparse_bucketing_on_card_matches_prep(cuda_device, dtype, case):
    """The device bucketing equals the plain one (``sparse_project_prep``:
    stable sort and ``searchsorted``) entry for entry, whatever order its
    atomics took; the projection on it matches the plain version, twice to
    the bit, and empty rows are zero.  Shared coordinates (``rows32768``, B=2
    against one COO pattern) and per-member ones (``per_member``); the
    row-block path (up to 24576 entries, also at 70000 rows) and the
    cooperative one (``rows32768``: 40000 entries)."""
    rng = np.random.default_rng(38)
    rows, cols, vals, mat, out_rows = _bucket_case(rng, case)
    r = torch.as_tensor(rows, device=cuda_device)
    r = r if r.dim() == 2 else r[None]
    perm, rowptr = SP.sparse_bucket_cuda(r, out_rows)
    want_perm, want_rowptr = SP.sparse_project_prep(r, out_rows)
    torch.cuda.synchronize()
    assert torch.equal(rowptr, want_rowptr)
    assert torch.equal(perm, want_perm)
    args = (r.reshape(rows.shape), torch.as_tensor(cols, device=cuda_device),
            t(vals, dtype, cuda_device), t(mat, dtype, cuda_device))
    before = _build.LAUNCHES["sparse_project"]
    got = SP.sparse_project_cuda(*args, out_rows)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sparse_project"] == before + 1
    want = SP.sparse_project_plain(*args, out_rows)
    assert got.shape == want.shape
    scale = max(float(want.abs().max()), 1e-300)
    assert float((got - want).abs().max()) / scale <= SPARSE_TOL[dtype]
    assert torch.equal(got, SP.sparse_project_cuda(*args, out_rows))
    assert float(got[..., out_rows - 5:, :].abs().max()) == 0.0
    walked = SP.sparse_project_launch(want_perm, want_rowptr, SP.cuda_operands(*args), out_rows)
    assert torch.equal(walked.reshape(got.shape), got)      # the walk alone, on the plain bucketing


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
@pytest.mark.parametrize("shape", [(1, 5, 4, 12, 6), (2, 37, 3, 45, 29), (3, 70, 5, 100, 33),
                                   (2, 100, 3, 45, 7), (1, 33, 4, 30, 1), (1, 300, 2, 408, 136)])
def test_nearfield_kernel_matches_plain(cuda_device, dtype, shape):
    """Ragged rows, sources and targets (not multiples of the kernel's row
    tiles, 8-source step or 48-target panel; capt = 1), zeroed source
    slots, masked targets and one exact zero denominator; two launches equal
    to the bit."""
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
@pytest.mark.parametrize("c3,offset", [(1100, 0), (45, 1), (46, 1)])
def test_nearfield_kernel_chunks_and_unaligned_weights(cuda_device, dtype, c3, offset):
    """More sources than one shared-memory panel holds (3cap 1100: two chunks
    in f64, two in f32, the second added to out in a fixed order), and w
    starting off a 16-byte boundary (read element by element)."""
    rng = np.random.default_rng(c3 + offset)
    bsz, r, nb, capt = 1, 40, 2, 50
    w = t(rng.normal(size=(bsz, r, nb, c3)), dtype, cuda_device)
    store = torch.empty(w.numel() + offset, dtype=dtype, device=cuda_device)
    w_off = store[offset:].view(w.shape)
    w_off.copy_(w)
    args = [w_off] + [t(v, dtype, cuda_device) for v in (
        rng.uniform(0, 1, (bsz, nb, c3)), rng.uniform(0, 1, (bsz, nb, capt)),
        rng.normal(size=(bsz, nb, capt)) * 1e-4)]
    args.append(torch.as_tensor(rng.uniform(size=(bsz, nb, capt)) > 0.2, device=cuda_device))
    got = NF.nearfield_cuda(*args)
    want = NF.nearfield_plain(w, *args[1:])
    torch.cuda.synchronize()
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


# Kernel C as redesigned (each Cauchy entry built once per launch into a
# panel, shared over a thread-block cluster where the panels alone leave SMs
# idle; f64 on the tensor cores): the method="pallas" route's shapes, a
# ragged one, more sources than one f64 panel of 48 targets holds, every plan
# giving the same bits, planted faults the check catches, and the counter.
CAUCHY_SHAPES = [(2, 5, 37, 29), (4, 128, 128, 128), (4, 192, 192, 192), (16, 17, 17, 17),
                 (16, 192, 192, 192), (2, 300, 1100, 70)]


def _cauchy_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", CAUCHY_SHAPES)
def test_cauchy_kernel_redesigned(cuda_device, dtype, shape):
    rng = np.random.default_rng(sum(shape))
    args = [t(x, dtype, cuda_device) for x in _cauchy_inputs(rng, *shape)]
    before = _build.LAUNCHES["cauchy_matmul"]
    got = cauchy_matmul_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["cauchy_matmul"] == before + 1
    want = cauchy_matmul_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert _cauchy_err(got, want) < CAUCHY_TOL[dtype]
    assert torch.equal(got, cauchy_matmul_cuda(*args))
    # planted faults: tau's sign flipped; each member's w taken from the next
    flipped = cauchy_matmul_cuda(args[0], args[1], args[2], -args[3], args[4])
    assert _cauchy_err(flipped, want) > CAUCHY_TOL[dtype]
    if shape[0] > 1:
        shifted = cauchy_matmul_cuda(args[0].roll(1, 0).contiguous(), *args[1:])
        assert _cauchy_err(shifted, want) > CAUCHY_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 64, 200, 50), (2, 300, 1100, 70), (4, 192, 192, 192)])
def test_cauchy_kernel_every_plan_same_bits(cuda_device, dtype, shape):
    """16, 32 or 48 targets a panel and 1, 2, 4 or 8 blocks a cluster: the
    same bits as the kernel's own plan (f64 at 48 targets and 1100 sources:
    two chunks of the panel)."""
    rng = np.random.default_rng(7 * sum(shape))
    args = [t(x, dtype, cuda_device) for x in _cauchy_inputs(rng, *shape)]
    base = cauchy_matmul_cuda(*args)
    assert _cauchy_err(base, cauchy_matmul_plain(*args)) < CAUCHY_TOL[dtype]
    for targets in (16, 32, 48):
        for cluster in (1, 2, 4, 8):
            got = cauchy_matmul_cuda_planned(*args, targets=targets, cluster=cluster)
            assert torch.equal(got, base), (targets, cluster)


def test_cauchy_kernel_plan_engages_the_cluster(cuda_device):
    """At B4 k=192, the full update's rotation at (128, 192) B4, two blocks
    share each panel; at B16 k=17 one block takes it alone."""
    assert cauchy_plan(4, 192, 192, 192, torch.float64)["cluster"] > 1
    assert cauchy_plan(4, 192, 192, 192, torch.float32)["cluster"] > 1
    assert cauchy_plan(16, 17, 17, 17, torch.float64)["cluster"] == 1
    rng = np.random.default_rng(65)
    args = [t(x, torch.float64, cuda_device) for x in _cauchy_inputs(rng, 4, 192, 192, 192)]
    with pytest.raises(ValueError, match="plan"):
        cauchy_matmul_cuda_planned(*args, targets=64, cluster=2)
    with pytest.raises(ValueError, match="expected shape"):
        cauchy_matmul_cuda(args[0], args[1][:, :-1].contiguous(), *args[2:])


# Kernel D as redesigned (a lane group per root holding its pole differences
# in registers, reciprocals without IEEE division): the default and the fused
# route's step counts, one group of fewer than 32 lanes, of 32, and of 256
# (5000 poles), ragged root counts, real brackets at the headline shape, a
# planted fault, and the refusal above MAX_POLES.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("steps", [(58, 4), (16, 6)])
@pytest.mark.parametrize("bsz,n,m", [(2, 37, 45), (3, 333, 150), (2, 2500, 19), (1, 5000, 7),
                                     (8, 1024, 1024)])
def test_secular_kernel_redesigned(cuda_device, dtype, steps, bsz, n, m):
    rng = np.random.default_rng(3 * n + m)
    args = [t(x, dtype, cuda_device) for x in _secular_random(rng, bsz, n, m)]
    _secular_check(args, *steps)
    dropped = args[1].clone()
    dropped.scatter_(1, dropped.argmax(1, keepdim=True), 0.0)
    want = SN.secular_solve_plain(*args, n_bisect=steps[0], n_newton=steps[1])
    fault = SN.secular_solve_cuda(args[0], dropped, *args[2:], n_bisect=steps[0],
                                  n_newton=steps[1])
    width = float((args[5] - args[4]).abs().max())
    assert float((fault - want).abs().max()) / width > SECULAR_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("steps", [(58, 4), (16, 6)])
def test_secular_kernel_redesigned_real_brackets(cuda_device, dtype, steps):
    """chip_smoke.py's headline: B8 N = M = 1024, brackets as core.secular
    builds them (every ninth root hugging its pole), every anchor a pole, so
    a root whose bracket is [0, 0] meets a zero difference at every step."""
    g = np.random.default_rng(21)
    d = np.sort(g.uniform(1, 9, (8, 1024)) ** 2, axis=1)
    z = g.normal(size=(8, 1024))
    z[:, ::9] *= 1e-5
    rho = g.uniform(0.5, 2.0, 8)
    br = SEC.secular_brackets(t(d, dtype, cuda_device), t(z, dtype, cuda_device),
                              t(rho, dtype, cuda_device), torch.full((8,), 1024, device=cuda_device))
    lo, hi = br.lo.clone(), br.hi.clone()
    lo[3, 100:110] = hi[3, 100:110] = 0.0
    args = [t(d, dtype, cuda_device), br.zc2, t(rho, dtype, cuda_device), br.anchor_vals, lo, hi]
    got = _secular_check(args, *steps)
    assert bool((got[3, 100:110] == 0.0).all())


def test_secular_kernel_plan_and_refusal(cuda_device):
    assert SN.secular_plan(1024) == {"lanes": 32, "terms": 32}
    assert SN.secular_plan(50) == {"lanes": 2, "terms": 25}
    assert SN.secular_plan(5000) == {"lanes": 256, "terms": 20}
    assert SN.secular_plan(SN.MAX_POLES + 1)["lanes"] == 0
    rng = np.random.default_rng(66)
    args = [t(x, torch.float64, cuda_device)
            for x in _secular_random(rng, 1, SN.MAX_POLES + 1, 3)]
    before = _build.LAUNCHES["secular_solve"]
    with pytest.raises(ValueError, match="at most"):
        SN.secular_solve_cuda(*args)
    assert _build.LAUNCHES["secular_solve"] == before


# -- the streaming service on the card (serve.SvdService) ------------------------------


def _service(method, dtype, mif, device, *, streams=8, m=64, n=96, r=8, seed=70, policy_kw=None):
    from repro_torch.serve import SvdService

    g = np.random.default_rng(seed)
    svc = SvdService(max_batch=streams, max_in_flight=mif,
                     policy=api.UpdatePolicy(method=method, **(policy_kw or {})))
    for i in range(streams):
        u = np.linalg.qr(g.normal(size=(m, r)))[0]
        v = np.linalg.qr(g.normal(size=(n, r)))[0]
        svc.register(f"s{i}", api.SvdState.from_factors(u, np.geomspace(100.0, 1.0, r), v,
                                                        device=device, dtype=dtype))
    return svc


def _service_traffic(seed=71, rounds=4, streams=8, m=64, n=96):
    g = np.random.default_rng(seed)
    return [(f"s{i}", g.normal(size=m), 10.0 * g.normal(size=n) / np.sqrt(m * n))
            for _ in range(rounds) for i in range(streams)]


def _service_states(svc):
    return {sid: [getattr(svc.state(sid), f) for f in ("u", "s", "v")] for sid in svc._streams}


@pytest.mark.parametrize("method", ["fused", "pallas", "direct"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_service_async_equals_sync_bitwise(cuda_device, method, dtype):
    runs = []
    for mif in (0, 2):
        svc = _service(method, dtype, mif, cuda_device)
        for sid, a, b in _service_traffic():
            svc.enqueue(sid, a, b)
        svc.drain()
        assert svc.in_flight() == 0
        runs.append(_service_states(svc))
    for sid in runs[0]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0][sid], runs[1][sid])), sid


@pytest.mark.parametrize("method", ["fused", "direct"])
def test_service_restore_bitwise_after_a_flush(cuda_device, method, tmp_path):
    """Saved with events pending after a flush, restored on the card: the
    resumed service gives the same bits as the one that never stopped."""
    from repro_torch.serve import SvdService

    traffic = _service_traffic(rounds=3)
    whole = _service(method, torch.float64, 2, cuda_device)
    part = _service(method, torch.float64, 2, cuda_device)
    for svc in (whole, part):
        svc.max_batch = 16                     # no autoflush: a pending FIFO at the save
        for sid, a, b in traffic[:12]:
            svc.enqueue(sid, a, b)
        svc.flush_round()
        svc.enqueue_op("s1", updates.Sparse(np.array([0, 1, 1], np.int32),
                                            np.array([2, 3, 5], np.int32),
                                            np.array([1.0, -2.0, 0.5]), rank=2))
    assert part.pending() > 0
    part.save(tmp_path, step=1)
    _, resumed = SvdService.restore(tmp_path, device=cuda_device)
    assert resumed.state("s0").u.is_cuda
    for svc in (whole, resumed):
        for sid, a, b in traffic[12:]:
            svc.enqueue(sid, a, b)
        svc.drain()
    got, want = _service_states(resumed), _service_states(whole)
    for sid in want:
        assert all(torch.equal(x, y) for x, y in zip(got[sid], want[sid])), sid


def _syncs(fn):
    """The places where ``fn`` makes the host wait for the device."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def test_health_probes_add_no_sync_when_not_due(cuda_device):
    """A fused flush round makes the host wait for nothing; with health
    probes off (or obs disabled) that stays so, and a due probe is the only
    wait it adds.  Observability changes neither the bits nor the launches."""
    from repro_torch import obs
    from repro_torch.obs import metrics as obs_metrics

    traffic = _service_traffic(rounds=4)
    prev = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    try:
        results = {}
        for label, pol, on in (("off", None, False), ("every 2, obs off", {"health_every": 2}, False),
                               ("every 2, obs on", {"health_every": 2}, True)):
            (obs.enable if on else obs.disable)()
            svc = _service("fused", torch.float64, 2, cuda_device, policy_kw=pol)
            for sid, a, b in traffic[:8]:       # warm round: every geometry seen
                svc.enqueue(sid, a, b)
            svc.drain()
            _build.reset_launches()
            waits = []
            for rnd in range(1, 4):
                waits.append(_syncs(lambda r_=rnd: [svc.enqueue(*ev)
                                                    for ev in traffic[8 * r_:8 * r_ + 8]]))
            svc.drain()
            results[label] = (waits, dict(_build.LAUNCHES), _service_states(svc))
        assert results["off"][0] == [[], [], []], results["off"][0]
        assert results["every 2, obs off"][0] == [[], [], []], results["every 2, obs off"][0]
        due = results["every 2, obs on"][0]
        assert due[0] and not due[1] and due[2], due           # ticks 2 and 4 sample
        launches = {k: v[1] for k, v in results.items()}
        assert launches["off"] == launches["every 2, obs off"] == launches["every 2, obs on"]
        for k in ("every 2, obs off", "every 2, obs on"):
            for sid, xs in results[k][2].items():
                assert all(torch.equal(x, y) for x, y in zip(xs, results["off"][2][sid]))
    finally:
        obs.disable()
        obs_metrics.set_registry(prev)


def test_warmup_builds_the_route_libraries(cuda_device):
    from repro_torch.core.engine import default_engine

    eng = default_engine("fused")
    eng.cache_clear()
    info = api.warmup(api.UpdatePolicy(method="fused"), m=64, n=96, rank=8, batch=8,
                      dtype=torch.float32, device=cuda_device)
    assert tuple(info) == (0, 1, 1)
    assert "fused_update_f32" in _build._libs
    out = updates.warmup_sketch(m=64, n=96, k=4, nnz=10, device=cuda_device)
    assert out[0].is_cuda and "sparse_proj" in _build._libs


# -- the mesh rows and the fleet on the card ----------------------------------------------


@pytest.mark.parametrize("full", [True, False], ids=["A", "B"])
def test_mesh_rows_equal_local_bits(cuda_device, full):
    """A mesh of four entries of the one card splits B = 13 into padded
    slices: kernels A and B give each update the same bits at every batch
    size, so the mesh row equals the local call to the bit."""
    from repro_torch.dist import make_host_mesh

    rng = np.random.default_rng(90)
    if full:
        probs = [svd_problem(rng, 32, 48) for _ in range(13)]
        sts = [convert.state_from_arrays(*p[:3], device=cuda_device) for p in probs]
    else:
        sts = [api.SvdState.from_dense(rng.normal(size=(64, 96)), 8, device=cuda_device)
               for _ in range(13)]
        probs = [(None, None, None, rng.normal(size=64), rng.normal(size=96)) for _ in range(13)]
    pol = api.UpdatePolicy(method="fused")
    A, B = [p[3] for p in probs], [p[4] for p in probs]
    _build.reset_launches()
    want = api.update_many(sts, A, B, pol)
    got = api.update_many(sts, A, B, pol.replace(mesh=make_host_mesh(4)))
    assert _build.LAUNCHES["fused_update" if full else "fused_update_truncated"] == 5
    for g, w in zip(got, want):
        assert g.u.is_cuda and all(torch.equal(getattr(g, f), getattr(w, f)) for f in "usv")


def test_fleet_settle_and_drain_across_shard_counts(cuda_device):
    """On the card a fleet's settle is the same bits on 1 and on 4 shards,
    and so is its drain (kernel B's bits do not depend on the batch)."""
    from repro_torch.fleet import SvdFleet

    rng = np.random.default_rng(91)
    states = [api.SvdState.from_dense(rng.normal(size=(64, 96)), 8, device="cpu")
              for _ in range(12)]
    traffic = [(f"s{i % 12}", rng.normal(size=64), rng.normal(size=96)) for i in range(60)]
    out = {}
    for shards in (1, 4):
        for continuous in (True, False):
            fl = SvdFleet(shards, policy=api.UpdatePolicy(method="fused"), devices="auto",
                          continuous=continuous, max_batch=16 if continuous else 1 << 30)
            for i, st in enumerate(states):
                fl.register(f"s{i}", st)
            for j, (sid, a, b) in enumerate(traffic):
                fl.enqueue(sid, a, b)
                if j % 7 == 6:
                    fl.pump()
            got = fl.settle([f"s{i}" for i in range(12)]) if not continuous else (
                fl.drain(), [fl.state(f"s{i}") for i in range(12)])[1]
            assert all(g.u.is_cuda for g in got)
            out[(shards, continuous)] = got
    for continuous in (True, False):
        for x, y in zip(out[(1, continuous)], out[(4, continuous)]):
            assert all(torch.equal(getattr(x, f), getattr(y, f)) for f in "usv")


# -- the training path (train.loop): no kernel of its own; the card against
# the port's own CPU path.  One f32 step differs by summation order; Adam's
# update is nearly each gradient entry's sign, so an entry rounded to the other
# sign moves its parameter by 2 lr (chip_smoke.py TRAIN_T2 has the readings).
TRAIN_LOSS_REL = 1e-5
TRAIN_PARAMS_REL = 1e-2


def _train_rel(got, want) -> float:
    from repro_torch._tree import tree_leaves

    return max(float((a.detach().cpu().double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30))
               for a, b in zip(tree_leaves(got), tree_leaves(want))
               if isinstance(a, torch.Tensor) and a.is_floating_point())


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_dot_on_the_card_matches_its_cpu_form(cuda_device, cd):
    """``layers.dot`` on the card (bf16 operands with float32 output through
    ``mm.dtype``) against its CPU form (the operands upcast to float32):
    bf16 products are exact in float32, so only the summation order differs
    (1e-5 of the largest output); the gradients are rounded to bf16, one bf16
    ulp (2**-8 relative) apart at most."""
    from repro_torch.models.layers import dot

    rng = np.random.default_rng(5)
    x, w, gy = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                for s in ((4, 9, 256), (256, 96), (4, 9, 96)))
    outs = []
    for dev in ("cpu", cuda_device):
        xt = x.to(dev).requires_grad_(True)
        wt = w.to(dev).requires_grad_(True)
        y = dot(xt, wt, cd)
        assert y.dtype == torch.float32
        outs.append((y, *torch.autograd.grad(y, (xt, wt), gy.to(dev))))
    tol = (1e-5, 1e-5 if cd == "float32" else 2.0 ** -8)
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())  # noqa: E731
    assert rel(outs[1][0], outs[0][0]) < tol[0]
    assert rel(outs[1][1], outs[0][1]) < tol[1] and rel(outs[1][2], outs[0][2]) < tol[1]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_bdot_on_the_card_matches_its_cpu_form(cuda_device, cd):
    """``layers.bdot``, attention's 3-D products (``bmm.dtype`` on the card),
    and its gradients, against its CPU form, at the limits of the 2-D test."""
    from repro_torch.models.layers import bdot

    rng = np.random.default_rng(6)
    a, b, gy = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                for s in ((6, 40, 128), (6, 128, 72), (6, 40, 72)))
    outs = []
    for dev in ("cpu", cuda_device):
        at = a.to(dev).requires_grad_(True)
        bt = b.to(dev).requires_grad_(True)
        y = bdot(at, bt, cd)
        assert y.dtype == torch.float32 and y.shape == (6, 40, 72)
        outs.append((y.detach(), *torch.autograd.grad(y, (at, bt), gy.to(dev))))
    tol = (1e-5, 1e-5 if cd == "float32" else 2.0 ** -8)
    rel = lambda x, w: float((x.cpu() - w).abs().max() / w.abs().max())  # noqa: E731
    assert rel(outs[1][0], outs[0][0]) < tol[0]
    assert rel(outs[1][1], outs[0][1]) < tol[1] and rel(outs[1][2], outs[0][2]) < tol[1]


@pytest.mark.parametrize("spectral", [False, True])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, spectral):
    from repro_torch import configs
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.spectral_adam import spectral_adam_init
    from repro_torch.train import loop

    sapi = build_model(configs.get_smoke("granite-34b"))
    opt = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=100, spectral_rank=8)
    p0 = sapi.init(torch.Generator().manual_seed(1), device="cpu")
    s0 = (spectral_adam_init(torch.Generator().manual_seed(2), p0, rank=8, device="cpu") if spectral
          else adamw_init(p0))
    runs = []
    for dev in ("cpu", cuda_device):
        params = _to(p0, dev)
        state = _to(s0, dev)
        losses = []
        for step in range(2):
            batch = batch_for_step(0, step, batch=2, seq=32, vocab=512, device=dev)
            params, state, loss, _ = loop.train_step(sapi, opt, params, state, batch, step,
                                                     spectral=spectral)
            losses.append(float(loss))
        runs.append((losses, params))
    (cl, cp), (gl, gp) = runs
    assert max(abs(a - b) / abs(b) for a, b in zip(gl, cl)) < TRAIN_LOSS_REL
    assert _train_rel(gp, cp) < TRAIN_PARAMS_REL
    assert all(x.is_cuda for x in _leaves_of(gp))


def test_bf16_loss_and_grads_on_the_card_match_the_cpu(cuda_device):
    """granite-34b's smoke config in bf16 compute, the dtype the full-width
    config runs: one forward and backward from one init on the card and on
    the CPU.  A bf16 rounding taken to the other neighbour moves what follows
    by a bf16 ulp: the loss at 1e-4, the gradients at two bf16 ulps of each
    leaf's largest entry (2**-6; chip_smoke.py TRAIN_T2_BF16 has the
    readings)."""
    from repro_torch import configs
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.models.registry import build_model
    from repro_torch.train import loop

    api = build_model(configs.get_smoke("granite-34b").replace(compute_dtype="bfloat16"))
    p0 = api.init(torch.Generator().manual_seed(1), device="cpu")
    batch = batch_for_step(0, 0, batch=2, seq=32, vocab=512, device="cpu")
    cpu_loss, cpu_grads = loop.loss_and_grads(api, p0, batch)
    card_loss, card_grads = loop.loss_and_grads(api, _to(p0, cuda_device), _to(batch, cuda_device))
    assert abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss)) < 1e-4
    assert _train_rel(card_grads, cpu_grads) < 2.0 ** -6
    assert all(x.is_cuda for x in _leaves_of(card_grads))


SPLIT_VALUES = [0.0, -0.0, 1e-40, -1e-45, 7.7e-34, -3.3e38, float("inf"), -float("inf"),
                float("nan")]


@pytest.mark.parametrize("shape,dim,length", [
    ((4105,), 0, 4105), ((4105,), 0, 512), ((37, 5, 29), 1, 2), ((37, 5, 29), 2, 8),
    ((3, 64, 96), 1, 16), ((3, 64, 96), 2, 40), ((1, 4096, 128), 1, 512),
    ((1, 4096, 128), 2, 128), ((2, 9, 8), 0, 1), ((2, 9, 8), 2, 3)])
def test_split_kernel_matches_plain(cuda_device, shape, dim, length):
    """``split_bf16x3``'s kernel against its plain version: the same bits
    wherever the plain version's plane is not NaN (a NaN's payload is the
    conversion's), NaN where it is; the 1-D cases hold 1e-30 .. 3e38 of
    both signs and the special values."""
    from repro_torch.kernels.split_bf16x3 import split_bf16x3_cuda, split_bf16x3_plain

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    if len(shape) == 1:
        mags = torch.logspace(-30, 38.47, shape[0] - len(SPLIT_VALUES), device=cuda_device)
        signs = torch.where(torch.rand(mags.shape, generator=gen, device=cuda_device) < 0.5, -1.0, 1.0)
        g = torch.cat([mags * signs, torch.tensor(SPLIT_VALUES, device=cuda_device)])
    else:
        g = torch.randn(shape, generator=gen, device=cuda_device) * torch.exp(
            torch.randn(shape, generator=gen, device=cuda_device) * 10)
    before = _build.LAUNCHES["split_bf16x3"]
    got = split_bf16x3_cuda(g, dim, length)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["split_bf16x3"] == before + 1
    want = split_bf16x3_plain(g, dim, length)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])


@pytest.mark.parametrize("shape,dim,length", [((37, 5, 29), 1, 2), ((3, 64, 96), 2, 40),
                                              ((2, 4096, 512), 1, 512), ((6144, 128), 1, 128),
                                              ((2, 9, 8), 2, 3)])
def test_repeat_kernel_matches_plain(cuda_device, shape, dim, length):
    """``repeat_bf16x3``'s kernel (a bf16 operand's chunks, three times)
    against its plain version, bit for bit."""
    from repro_torch.kernels.split_bf16x3 import repeat_bf16x3_cuda, repeat_bf16x3_plain

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(shape, generator=gen, device=cuda_device).bfloat16()
    before = _build.LAUNCHES["repeat_bf16x3"]
    got = repeat_bf16x3_cuda(x, dim, length)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["repeat_bf16x3"] == before + 1
    assert torch.equal(got.view(torch.int16), repeat_bf16x3_plain(x, dim, length).view(torch.int16))


# (g, a, b) of a product a @ b, shapes cut from the cells: granite's MLP input
# matrix at 4096 tokens (its dW contracts the tokens), granite's MQA score
# product q k^T at 8 of its 48 heads (dS K contracts 4096 keys, q^T dS 8 x 4096
# rows), and DeepSeek-V2-Lite's latent score product q_abs c_kv^T at 4 of its
# 16 heads
SPLIT_SHAPES = {"granite-mlp": ((4096, 24576), (4096, 6144), (6144, 24576)),
                "granite-mqa-scores": ((1, 8 * 4096, 4096), (1, 8 * 4096, 128), (1, 128, 4096)),
                "v2lite-mla-latent": ((1, 4 * 4096, 4096), (1, 4 * 4096, 512), (1, 512, 4096))}


@pytest.mark.parametrize("case", list(SPLIT_SHAPES))
def test_split_products_within_twice_the_float32_error_on_the_card(cuda_device, case,
                                                                   record_property):
    """``g b^T`` and ``a^T g`` through the three planes against the float64
    product: at most twice the error of the float32 product the backward
    took before (``||C - C64||_F / ||C64||_F``; both recorded).  The tensor
    cores' float32 accumulator rounds toward zero, so unchunked the planes'
    products read 4-17x the float32 error at these shapes."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    gs, as_, bs = SPLIT_SHAPES[case]
    g = torch.randn(gs, generator=gen, device=cuda_device)
    a = torch.randn(as_, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(bs, generator=gen, device=cuda_device).bfloat16()
    want = (torch.matmul(g.double(), b.double().mT), torch.matmul(a.double().mT, g.double()))
    f32 = (torch.matmul(g, b.float().mT), torch.matmul(a.float().mT, g))
    split = L._split_products(g, a, b, True, True)
    for name, w, x, y in zip(("ga", "gb"), want, f32, split):
        err_f32 = float((x.double() - w).norm() / w.norm())
        err_split = float((y.double() - w).norm() / w.norm())
        record_property(f"{name}_err_f32", err_f32)
        record_property(f"{name}_err_split", err_split)
        print(f"{case} {name}: float32 {err_f32:.3e}, split {err_split:.3e}")
        assert y.dtype == torch.float32 and y.shape == w.shape
        assert err_split <= 2 * err_f32, (case, name, err_split, err_f32)


@pytest.mark.parametrize("cd,path", [("bfloat16", "split"), ("float16", "float32"),
                                     ("float32", None)])
def test_smoke_step_backward_products_by_path(cuda_device, cd, path):
    """granite-34b's smoke config, one forward and backward on the card with
    ``obs`` enabled: in bf16 every backward product takes the three planes,
    as many as the CPU's float32 path counts at the same config; float16
    keeps the float32 product, and float32 compute never reaches the
    backward of ``_DotF32``."""
    from repro_torch import configs
    from repro_torch import obs
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build_model
    from repro_torch.train import loop

    api = build_model(configs.get_smoke("granite-34b").replace(compute_dtype=cd))
    p0 = api.init(torch.Generator().manual_seed(1), device="cpu")
    batch = batch_for_step(0, 0, batch=2, seq=32, vocab=512, device="cpu")
    counts = {}
    obs.enable()
    try:
        L.read_counters()
        for dev in ("cpu", cuda_device):
            loop.loss_and_grads(api, _to(p0, dev), _to(batch, dev))
            counts[dev] = L.read_counters()
    finally:
        obs.disable()
    on_cpu, on_card = counts["cpu"], counts[cuda_device]
    assert on_cpu["split"] == 0
    if path is None:
        assert on_cpu == on_card == {"split": 0, "float32": 0}
    else:
        assert on_cpu["float32"] > 0
        other = "float32" if path == "split" else "split"
        assert on_card == {path: on_cpu["float32"], other: 0}


def _leaves_of(tree):
    from repro_torch._tree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _to(tree, dev):
    from repro_torch._tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [x if x.dim() == 0 and x.dtype == torch.int32 else x.to(dev)
                                 for x in tree_leaves(tree)])


def test_train_resume_on_the_card_is_exact(cuda_device, tmp_path, monkeypatch):
    """Saved at step 2 and resumed to 4 under deterministic algorithms: the
    same losses and the same checkpoint bits as the uninterrupted run."""
    from repro_torch import configs
    from repro_torch.configs.base import OptimizerConfig, RunConfig
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import loop

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        def run(d, steps):
            return RunConfig(model=configs.get_smoke("granite-34b"),
                             optimizer=OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=100),
                             steps=steps, log_every=1, checkpoint_every=2,
                             checkpoint_dir=str(tmp_path / d))

        whole = loop.train(run("whole", 4), batch_size=2, seq_len=32)
        loop.train(run("resumed", 2), batch_size=2, seq_len=32)
        resumed = loop.train(run("resumed", 4), batch_size=2, seq_len=32)
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.resumed_from == 2
    assert [v for _, v in whole.losses][2:] == [v for _, v in resumed.losses]
    (sa, la), (sb, lb) = ck.restore(tmp_path / "whole", None), ck.restore(tmp_path / "resumed", None)
    assert sa == sb == 4
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(la, lb))


# -- token serving (serve.engine.generate) --------------------------------------------

# smoke-config prefill and decode logits, card against CPU, relative to the
# largest logit (float32 compute, TF32 off: the two devices sum in other orders)
SERVE_LOGITS_REL = 1e-5


@pytest.mark.parametrize("arch", ["granite-34b", "qwen2-72b", "deepseek-moe-16b",
                                  "deepseek-v2-lite-16b", "zamba2-7b"])
def test_generate_on_the_card_equals_the_cpu(cuda_device, arch):
    """Greedy and sampled (temperature 0.7) tokens equal on the card and the
    CPU; the prefill's and a decode step's logits within SERVE_LOGITS_REL."""
    from repro_torch import configs
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, generate

    cfg = configs.get_smoke(arch)
    api = build_model(cfg)
    p_cpu = api.init(torch.Generator().manual_seed(0), device="cpu")
    p_card = _to(p_cpu, cuda_device)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)),
                              dtype=torch.int32)
    for sc in (ServeConfig(max_new_tokens=8), ServeConfig(8, 0.7, 3)):
        want = generate(api, p_cpu, prompts, sc)
        got = generate(api, p_card, prompts.to(cuda_device), sc)
        assert got.is_cuda and torch.equal(got.cpu(), want), sc
    with torch.inference_mode():
        logits = []
        for p, dev in ((p_cpu, "cpu"), (p_card, cuda_device)):
            lp, cache = api.prefill(p, {"tokens": prompts.to(dev)}, max_len=20)
            ld, _ = api.decode_step(p, cache, prompts[:, :1].to(dev), 16)
            logits.append((lp.cpu(), ld.cpu()))
    for got, want in zip(logits[1], logits[0]):
        assert float((got - want).abs().max() / want.abs().max()) < SERVE_LOGITS_REL


@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v2-lite-16b", "zamba2-7b"])
def test_greedy_decode_step_makes_no_host_wait(cuda_device, arch):
    """A greedy step of ``generate`` (decode, argmax, the token kept on the
    card) never asks the host for device data."""
    from repro_torch import configs
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import _sample

    cfg = configs.get_smoke(arch)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32, device=cuda_device)
    with torch.inference_mode():
        logits, cache = api.prefill(params, {"tokens": prompts}, max_len=24)
        token = _sample(logits[:, -1, :], 0.0, None)[:, None]
        box = {"cache": cache, "token": token, "out": [token]}

        def step(pos):
            lg, box["cache"] = api.decode_step(params, box["cache"], box["token"], pos)
            box["token"] = _sample(lg[:, -1, :], 0.0, None)[:, None]
            box["out"].append(box["token"])

        step(16)
        assert _syncs(lambda: step(17)) == []
        assert _syncs(lambda: torch.cat(box["out"], dim=1)) == []


def _family_batch(cfg, dev, b=2, s=16):
    """Prompts (and, for the encoder-decoder, 24 frames) from a seed."""
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                       dtype=torch.int32).to(dev)}
    if cfg.encdec:
        batch["frames"] = torch.as_tensor(rng.normal(size=(b, 24, cfg.d_model)) * 0.02,
                                          dtype=torch.float32).to(dev)
    return batch


def _family_greedy(api, params, batch, steps, pos_as_tensor=False):
    """Prefill + greedy decode_step (these families have no ``generate``):
    the logits of each step and the tokens."""
    kw = {"max_dec_len": batch["tokens"].shape[1] + steps} if api.cfg.encdec else {}
    with torch.inference_mode():
        logits, cache = api.prefill(params, batch, **kw)
        outs, toks = [logits[:, -1]], []
        for i in range(steps):
            token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks.append(token)
            pos = batch["tokens"].shape[1] + i
            if pos_as_tensor:
                pos = torch.tensor(pos, dtype=torch.int32, device=token.device)
            logits, cache = api.decode_step(params, cache, token, pos)
            outs.append(logits[:, 0])
    return outs, torch.cat(toks, dim=1)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-base"])
def test_rwkv_and_encdec_on_the_card_equal_the_cpu(cuda_device, arch):
    """Prefill + 6 greedy decode steps at the smoke config: tokens equal on
    the card and the CPU, logits within SERVE_LOGITS_REL of the largest; a
    0-dim tensor ``pos`` on the card gives the int's bits."""
    from repro_torch import configs
    from repro_torch.models.registry import build_model

    cfg = configs.get_smoke(arch)
    api = build_model(cfg)
    p_cpu = api.init(torch.Generator().manual_seed(0), device="cpu")
    p_card = _to(p_cpu, cuda_device)
    want, want_toks = _family_greedy(api, p_cpu, _family_batch(cfg, "cpu"), 6)
    got, got_toks = _family_greedy(api, p_card, _family_batch(cfg, cuda_device), 6)
    again, again_toks = _family_greedy(api, p_card, _family_batch(cfg, cuda_device), 6,
                                       pos_as_tensor=True)
    assert torch.equal(got_toks.cpu(), want_toks) and torch.equal(again_toks, got_toks)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        v = cfg.vocab_size
        assert float((g[:, :v].cpu() - w[:, :v]).abs().max() / w[:, :v].abs().max()) < SERVE_LOGITS_REL


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-base"])
@pytest.mark.parametrize("pos_as_tensor", [False, True], ids=["int-pos", "tensor-pos"])
def test_rwkv_and_encdec_decode_step_makes_no_host_wait(cuda_device, arch, pos_as_tensor):
    """A greedy decode step (the token kept on the card) never asks the host
    for device data, whether ``pos`` is an int or a tensor on the card."""
    from repro_torch import configs
    from repro_torch.models.registry import build_model

    cfg = configs.get_smoke(arch)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    batch = _family_batch(cfg, cuda_device)
    kw = {"max_dec_len": 24} if cfg.encdec else {}
    with torch.inference_mode():
        logits, cache = api.prefill(params, batch, **kw)
        box = {"cache": cache, "token": logits[:, -1].argmax(-1).to(torch.int32)[:, None]}

        def step(pos):
            lg, box["cache"] = api.decode_step(params, box["cache"], box["token"], pos)
            box["token"] = lg[:, -1].argmax(-1).to(torch.int32)[:, None]

        pos = [torch.tensor(p, dtype=torch.int32, device=cuda_device) if pos_as_tensor else p
               for p in (16, 17)]
        step(pos[0])
        assert _syncs(lambda: step(pos[1])) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wkv_chunked_equals_the_recurrence_on_the_card(cuda_device, dtype):
    """The chunked WKV against the recurrence on the card (init-like decays,
    a non-zero state), relative to their largest value, and the card's
    chunked form against the CPU's."""
    from repro_torch.models import rwkv as RW

    rng = np.random.default_rng(3)
    b, l, h, dk = 2, 64, 4, 16
    ins = [rng.normal(size=(b, l, h, dk)) for _ in range(3)] + [
        -rng.uniform(0.01, 0.3, (b, l, h, dk)), rng.normal(size=(h, dk)),
        rng.normal(size=(b, h, dk, dk))]
    cpu = [torch.as_tensor(a, dtype=dtype) for a in ins]
    card = [a.to(cuda_device) for a in cpu]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    y_c, s_c = RW._wkv_chunked(*card, chunk=16)
    y_r, s_r = RW.wkv_recurrent(*card)
    y_h, s_h = RW._wkv_chunked(*cpu, chunk=16)
    for got, want in ((y_c, y_r), (s_c, s_r), (y_c.cpu(), y_h), (s_c.cpu(), s_h)):
        assert float((got - want).abs().max() / want.abs().max()) < tol


def test_threefry_bits_on_the_card_equal_the_cpu(cuda_device):
    from repro_torch.serve import engine as E

    key = E.split(E.prng_key(2**32 + 9))[1]
    for shape in ((5,), (8, 102400)):
        assert torch.equal(E.random_bits(key, shape, cuda_device).cpu(),
                           E.random_bits(key, shape, "cpu"))
    assert torch.equal(E.gumbel(key, (8, 4096), cuda_device).cpu().isfinite(),
                       torch.ones(8, 4096, dtype=torch.bool))


@pytest.mark.parametrize("arch", ["granite-34b", "deepseek-moe-16b"])
def test_mesh_train_step_on_the_card_matches_the_meshless_step(cuda_device, arch):
    """The (4, 2) mesh step of chip_smoke (m1) at a smoke config: the batch
    split over four entries of the card, against the mesh-less step on the
    same batch from one init (f32, TF32 off): the loss and the parameters at
    the reference's own limits for a sharded step (1e-5, 1e-4)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.dist import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import loop

    cfg = configs.get_smoke(arch)
    if cfg.moe is not None:      # 4 groups of 64 tokens, one whole group a slice
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, group_size=64))
    sapi = build_model(cfg)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    params = sapi.init(torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    state = adamw_init(params)
    batch = batch_for_step(0, 0, batch=8, seq=32, vocab=cfg.vocab_size, device=cuda_device)
    mesh = make_host_mesh(4, 2, device=cuda_device)
    assert {d.type for d in mesh.devices.flat} == {"cuda"}
    p_ref, _, l_ref, _ = loop.train_step(sapi, opt, params, state, batch, 0, spectral=False)
    p_mesh, _, l_mesh, _ = loop.train_step(sapi, opt, params, state, batch, 0, spectral=False,
                                           mesh=mesh)
    assert abs(float(l_mesh) - float(l_ref)) < 1e-5
    for a, b in zip(_leaves_of(p_mesh), _leaves_of(p_ref)):
        assert a.is_cuda and float((a - b).abs().max()) < 1e-4


def test_reshard_onto_a_card_mesh_is_bitwise(cuda_device):
    from repro_torch import configs
    from repro_torch.dist import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train.elastic import plan_mesh, reshard

    sapi = build_model(configs.get_smoke("qwen1.5-32b"))
    host = sapi.init(torch.Generator().manual_seed(0), device="cpu")
    for mesh in (plan_mesh(device=cuda_device), make_host_mesh(4, 2, device=cuda_device)):
        placed = reshard(host, mesh)
        for a, b in zip(_leaves_of(placed), _leaves_of(host)):
            assert a.is_cuda and a.dtype == b.dtype
            assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError, match="does not evenly divide"):
        reshard(host, make_host_mesh(3, 1, device=cuda_device))


def test_span_device_times_on_the_card(cuda_device):
    """``obs.start_tracing(device=True)``: each span's card time, in enter
    order; a span inside a CUDA graph's capture records no event (the
    capture succeeds and replays)."""
    from repro_torch import obs

    x = torch.randn(2048, 2048, device=cuda_device)
    torch.cuda.synchronize()
    obs.clear_trace()
    obs.start_tracing(device=True)
    try:
        with obs.span("outer", k=8):
            with obs.span("mm"):
                y = x
                for _ in range(8):
                    y = (y @ x) / 2048 ** 0.5
        static = x.clone()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with obs.span("captured"):
                static.mul_(2.0)
        graph.replay()
    finally:
        obs.stop_tracing()
    times = obs.device_times()
    obs.clear_trace()
    assert [(t["name"], t["args"]) for t in times] == [("outer", {"k": 8}), ("mm", {})]
    assert 0 < times[1]["ms"] <= times[0]["ms"]
    torch.cuda.synchronize()
    assert torch.equal(static, x * 2.0)


# -- the truncated update's core replayed from a CUDA graph (core.graph) -----------------


def _core_graph_problem(rng, bsz, m, n, r, dtype, device):
    """Rank-r states whose (r+1) cores have repeated poles and zero ``z``
    entries: the deflation both rotates and drops coordinates."""
    u = np.stack([np.linalg.qr(rng.normal(size=(m, r)))[0] for _ in range(bsz)])
    v = np.stack([np.linalg.qr(rng.normal(size=(n, r)))[0] for _ in range(bsz)])
    s = np.tile(np.geomspace(10.0, 0.1, r), (bsz, 1))
    s[:, 3:6] = s[:, 3:4]
    ca, cb = rng.normal(size=(bsz, r)), rng.normal(size=(bsz, r))
    ca[:, [1, 7]] = cb[:, [1, 7]] = 0.0
    a, b = ((w @ c[:, :, None] + 0.1 * (e - w @ (w.transpose(0, 2, 1) @ e)))[:, :, 0]
            for w, c, e in ((u, ca, rng.normal(size=(bsz, m, 1))),
                            (v, cb, rng.normal(size=(bsz, n, 1)))))
    return [t(x, dtype, device) for x in (u, s, v, a, b)]


def _core_graph_counts():
    from repro_torch import obs

    return tuple(getattr(obs.registry().get(f"svd_core_graph_{k}"), "value", 0)
                 for k in ("captures", "replays", "fallbacks"))


@pytest.fixture
def core_graphs():
    """An empty graph cache and a fresh, enabled metrics registry."""
    from repro_torch import obs
    from repro_torch.core.graph import CORE_GRAPHS
    from repro_torch.obs import metrics as obs_metrics

    CORE_GRAPHS.clear()
    prev = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    obs.enable()
    try:
        yield CORE_GRAPHS
    finally:
        obs.disable()
        obs_metrics.set_registry(prev)
        CORE_GRAPHS.clear()


def _truncated(prob):
    from repro_torch.core.svd_update import TruncatedSvd, _svd_update_truncated_impl

    u, s, v, a, b = prob
    return _svd_update_truncated_impl(TruncatedSvd(u, s, v), a, b, method="direct")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bsz", [1, 4])
def test_core_graph_replay_equals_eager_bitwise(cuda_device, core_graphs, dtype, bsz):
    """At k = 33 the replayed core gives the eager update's bits, and a call
    whose inputs differ from the captured call's returns its own result."""
    rng = np.random.default_rng(120 + bsz)
    p, x = (_core_graph_problem(rng, bsz, 48, 72, 32, dtype, cuda_device) for _ in range(2))
    want_x = _truncated(x)                  # first sighting: eager
    core_graphs.clear()
    want_p = _truncated(p)                  # eager again, for p
    got = [_truncated(p), _truncated(x), _truncated(p)]     # capture, then replays
    assert _core_graph_counts() == (1, 3, 0)
    for g, w in zip(got, (want_p, want_x, want_p)):
        assert all(torch.equal(gf, wf) for gf, wf in zip(g, w))
    assert not torch.equal(got[0].s, got[1].s)


def test_core_graph_shared_across_state_shapes(cuda_device, core_graphs):
    """Two truncated states of other (m, n) with one core key: one capture,
    then replays, each equal to the eager update to the bit."""
    rng = np.random.default_rng(130)
    probs = [_core_graph_problem(rng, 1, m, n, 32, torch.float32, cuda_device)
             for m, n in ((40, 64), (96, 80))]
    want = []
    for prob in probs:
        core_graphs.clear()
        want.append(_truncated(prob))
    core_graphs.clear()
    for i in range(6):
        got = _truncated(probs[i % 2])
        assert all(torch.equal(g, w) for g, w in zip(got, want[i % 2]))
    assert _core_graph_counts() == (1, 5, 0)


def test_core_graph_never_captures_above_the_givens_limit(cuda_device, core_graphs):
    """k = 65 > GIVENS_LOOP_MAX: the Givens loop asks the host, so the core
    stays eager on every call."""
    rng = np.random.default_rng(131)
    prob = _core_graph_problem(rng, 2, 80, 96, 64, torch.float32, cuda_device)
    outs = [_truncated(prob) for _ in range(3)]
    assert _core_graph_counts() == (0, 0, 0)
    assert all(torch.equal(g, w) for g, w in zip(outs[2], outs[0]))


def _v2_options_model(dev):
    from repro_torch.configs.base import (MLAPortConfig, ModelConfig, MoEPortConfig,
                                          YarnConfig)
    from repro_torch.models.registry import build_model

    cfg = ModelConfig(
        name="v2-options", family="moe", n_layers=3, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=384, vocab_size=2048, compute_dtype="bfloat16", remat=True,
        moe=MoEPortConfig(n_routed=16, n_shared=1, top_k=4, d_ff_expert=128, n_held=4,
                          held_start=4, norm_topk=False, first_dense=1, seq_aux_alpha=0.001,
                          group_size=256),
        mla=MLAPortConfig(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                          v_head_dim=32, yarn=YarnConfig(original_max_position=64)))
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.randint(0, 2048, (2, 513), generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    return api, params, {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int()}


def test_moe_path_waits_for_nothing_with_obs_off(cuda_device):
    """DeepSeek-V2's options (expert share, leading dense layer, YaRN, the
    balance loss) on the card: a forward and backward with ``obs`` off makes
    the host wait nowhere; with ``obs`` on the counters add no wait either
    until ``read_counters``, which reads once."""
    from repro_torch import obs
    from repro_torch.models import moe
    from repro_torch.train import loop

    api, params, batch = _v2_options_model(cuda_device)
    loop.loss_and_grads(api, params, batch)                  # warm
    assert _syncs(lambda: loop.loss_and_grads(api, params, batch)) == []
    obs.enable()
    try:
        assert _syncs(lambda: loop.loss_and_grads(api, params, batch)) == []
        counts = moe.read_counters()
    finally:
        obs.disable()
    assert 0 < counts["routed_held"] <= 2 * 512 * 4 * 2


def test_donated_step_is_the_same_on_the_card(cuda_device):
    """``train_step(..., donate=True)`` gives the bits of the undonated step
    on the card, under spectral-Adam and AdamW."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.spectral_adam import spectral_adam_init
    from repro_torch.train import loop

    api, params, batch = _v2_options_model(cuda_device)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=100, spectral_rank=8,
                          basis_refresh_every=2)
    for spectral in (True, False):
        runs = []
        for donate in (False, True):
            p = tree_map(lambda x: x.clone(), params)
            st = (spectral_adam_init(torch.Generator(device=cuda_device).manual_seed(2), p,
                                     rank=8, device=cuda_device)
                  if spectral else adamw_init(p))
            for step in range(4):
                p, st, _, _ = loop.train_step(api, opt, p, st, batch, step, spectral=spectral,
                                              donate=donate)
            runs.append([x.clone() for x in tree_leaves(p)])
        assert all(torch.equal(a, b) for a, b in zip(*runs)), spectral
