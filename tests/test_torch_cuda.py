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
