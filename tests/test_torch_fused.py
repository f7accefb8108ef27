"""Port parity: the fused update body against the reference's fused Pallas
kernels in interpret mode (f64, atol 1e-10), bf16 storage within
``BF16_ERROR_BUDGET`` (kernels A and B against their plain version on the
card are in test_torch_cuda.py).  ``v``'s trailing null columns are an arbitrary basis and are
never compared: only ``u``, ``s``, ``d_left`` and ``v[:, :m]``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import np_, ref, spectrum_problem, svd_problem, t, truncated_problem
from repro_torch.kernels import _build
from repro_torch.kernels import fused_update as F
from repro_torch.kernels import ref as ref_oracles

ATOL = 1e-10
RF = ref("kernels.fused_update")


def _check_full(got, want, m, atol=ATOL):
    for i, name in ((0, "u"), (1, "s"), (3, "d_left")):
        np.testing.assert_allclose(np_(got[i]), np.asarray(want[i]), atol=atol, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(np_(got[2])[..., :m], np.asarray(want[2])[..., :m], atol=atol,
                               rtol=0, err_msg="v[:, :m]")


@pytest.mark.parametrize("m,n", [(8, 12), (16, 16), (16, 24), (32, 48)])
def test_fused_body_matches_pallas(m, n):
    rng = np.random.default_rng(m * 100 + n)
    prob = svd_problem(rng, m, n)
    want = RF.fused_update_pallas(*map(jnp.asarray, prob), interpret=True)
    got = F._fused_body(*(t(x[None]) for x in prob))
    _check_full([x[0] for x in got], want, m)


def test_fused_body_matches_port_phase_chain():
    """The plain fused body against the port's own unfused phase chain
    (``kernels.ref.svd_update_fused_ref``), an independent implementation."""
    rng = np.random.default_rng(12)
    stack = [np.stack(x) for x in zip(*(svd_problem(rng, 16, 24) for _ in range(2)))]
    args = [t(x) for x in stack]
    got = F._fused_body(*args)
    want = ref_oracles.svd_update_fused_ref(*args)
    _check_full(got, [w.numpy() for w in want], 16)


def test_fused_body_batched_and_repeated_spectrum():
    rng = np.random.default_rng(11)
    probs = [svd_problem(rng, 8, 12), svd_problem(rng, 8, 12, repeated=True)]
    stack = [np.stack(x) for x in zip(*probs)]
    want = RF.fused_update_pallas_batched(*map(jnp.asarray, stack), interpret=True)
    got = F.fused_update_batched(*(t(x) for x in stack))
    _check_full(got, want, 8)


@pytest.mark.parametrize("m,n,r", [(12, 20, 4), (20, 30, 5)])
def test_fused_truncated_body_matches_pallas(m, n, r):
    rng = np.random.default_rng(m + n + r)
    probs = [truncated_problem(rng, m, n, r) for _ in range(2)]
    stack = [np.stack(x) for x in zip(*probs)]
    want = RF.fused_update_truncated_pallas_batched(*map(jnp.asarray, stack), interpret=True)
    got = F.fused_update_truncated_batched(*(t(x) for x in stack))
    for g, w, name in zip(got, want, ("u", "s", "v")):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=ATOL, rtol=0, err_msg=name)
    single = RF.fused_update_truncated_pallas(*map(jnp.asarray, probs[0]), interpret=True)
    for g, w in zip(got, single):
        np.testing.assert_allclose(np_(g[0]), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("m,n,rank,dtype", [
    (32, 48, None, torch.float64), (256, 320, None, torch.float32),
    (256, 384, None, torch.float32), (512, 768, 16, torch.float32),
    (1024, 4096, 32, torch.float64), (300, 300, None, torch.bfloat16),
])
def test_fused_supported_matches_reference(m, n, rank, dtype):
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32,
           torch.bfloat16: jnp.bfloat16}[dtype]
    assert F.fused_supported(m, n, rank, dtype) == RF.fused_supported(m, n, rank, dtype=jdt)


def test_bf16_storage_within_budget():
    """bf16 storage: singular values within the budget against an f64 SVD, and
    the reconstruction error (the reference's measure, max |U S V^T - target|
    / max |target|) equal to the reference's own on the same bf16 inputs.  The
    reference meets its ``recon_rel`` budget on part of such problems only, so
    the port is held to the reference there, not to the budget."""
    rng = np.random.default_rng(21)
    m, n = 32, 48
    prob = svd_problem(rng, m, n)
    u, s, v, a, b = prob
    target = (u * s) @ v[:, :m].T + np.outer(a, b)
    s_ref = np.linalg.svd(target, compute_uv=False)

    def measures(uo, so, vo):
        uo, so, vo = (np.asarray(x, np.float64) for x in (uo, so, vo))
        rec = (uo * so) @ vo[:, :m].T
        return (np.max(np.abs(so - s_ref)) / s_ref[0],
                np.abs(rec - target).max() / np.abs(target).max())

    out = F._fused_body(*(t(x[None], torch.bfloat16) for x in prob))
    assert all(x.dtype == torch.bfloat16 for x in out)
    sigma_rel, recon_rel = measures(*(np_(x[0]) for x in out[:3]))
    want = RF.fused_update_xla(*(jnp.asarray(x, jnp.bfloat16) for x in prob))
    _, recon_ref = measures(*want[:3])
    assert sigma_rel < F.BF16_ERROR_BUDGET["sigma_rel"]
    assert abs(recon_rel - recon_ref) < 1e-2


def _recon_fro(out, target):
    """||U S V^T - T||_F / ||T||_F of a single full update (numpy)."""
    u, s, v = (np.asarray(x, np.float64) for x in out[:3])
    return np.linalg.norm((u * s) @ v[:, :len(s)].T - target) / np.linalg.norm(target)


@pytest.mark.parametrize("kind", ["uniform", "spectrum"])
def test_f32_body_matches_reference_at_gate_edge(kind):
    """float32 at (256, 320), the largest full geometry the fused gate takes in
    f32: the port's plain body against the reference's fused body on the same
    f32 inputs, and both against the f64 truth.  The route's own f32 error
    (several 1e-2 to 0.3 in Frobenius) is the reference's: the port meets it
    to 1e-3."""
    m, n = 256, 320
    rng = np.random.default_rng(256)
    prob = svd_problem(rng, m, n) if kind == "uniform" else spectrum_problem(rng, m, n)
    prob = [np.asarray(x, np.float32) for x in prob]
    u, s, v, a, b = (x.astype(np.float64) for x in prob)
    target = (u * s) @ v[:, :m].T + np.outer(a, b)
    want = RF.fused_update_xla(*map(jnp.asarray, prob))
    got = [np_(x[0]) for x in F._fused_body(*(t(x[None], torch.float32) for x in prob))]
    w_rec = (np.asarray(want[0], np.float64) * np.asarray(want[1], np.float64)) \
        @ np.asarray(want[2], np.float64)[:, :m].T
    assert _recon_fro(got, w_rec) < 1e-3
    # singular values carry absolute f32 error of order eps * sigma_max^2 in
    # their squares, so they are compared against sigma_max
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-4,
                               atol=2e-5 * float(np.max(want[1])))
    assert abs(_recon_fro(got, target) - _recon_fro(want, target)) < 1e-3


def test_cpu_dispatch_takes_plain_body():
    rng = np.random.default_rng(22)
    prob = [t(x[None]) for x in svd_problem(rng, 6, 9)]
    before = dict(_build.LAUNCHES)
    got = F.fused_update_batched(*prob)
    assert _build.LAUNCHES == before
    for g, w in zip(got, F._fused_body(*prob)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
