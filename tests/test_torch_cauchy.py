"""Port parity: the Cauchy product.  The plain version against the reference's
Pallas kernel in interpret mode (single and batched, f32 and f64), the stable
core product and its kernel route against the reference (kernel C against its
plain version on the card is in test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref, t
from repro_torch.core import cauchy as TC
from repro_torch.kernels import _build, ops
from repro_torch.kernels.cauchy_matmul import (
    cauchy_matmul,
    cauchy_matmul_plain,
)

RK = ref("kernels.cauchy_matmul")
RC = ref("core.cauchy")
ROPS = ref("kernels.ops")

# f64 agrees to rounding; f32 sums N terms of magnitude up to |w| / min|den|
TOL = {torch.float64: 1e-12, torch.float32: 2e-4}


def _inputs(rng, bsz, r, n, m):
    src = np.sort(rng.normal(size=(bsz, n)), axis=1)
    w = rng.normal(size=(bsz, r, n))
    pick = rng.integers(0, n, size=(bsz, m))
    av = np.take_along_axis(src, pick, axis=1)
    tau = rng.normal(size=(bsz, m)) * 1e-2
    tau[:, 0] = 0.0                                    # an exact pole: the 1/0 guard
    tmask = rng.random((bsz, m)) > 0.2
    return w, src, av, tau, tmask


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_matches_pallas_single(dtype):
    rng = np.random.default_rng(1)
    w, src, av, tau, tm = _inputs(rng, 1, 5, 37, 29)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = RK.cauchy_matmul_pallas(jnp.asarray(w[0], jdt), jnp.asarray(src[0], jdt),
                                   jnp.asarray(av[0], jdt), jnp.asarray(tau[0], jdt),
                                   jnp.asarray(tm[0]), interpret=True)
    got = cauchy_matmul_plain(t(w, dtype), t(src, dtype), t(av, dtype), t(tau, dtype),
                              torch.as_tensor(tm))
    assert _rel(got[0].numpy(), np.asarray(want)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_matches_pallas_batched(dtype):
    rng = np.random.default_rng(2)
    w, src, av, tau, tm = _inputs(rng, 3, 6, 40, 33)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = RK.cauchy_matmul_pallas_batched(
        jnp.asarray(w, jdt), jnp.asarray(src, jdt), jnp.asarray(av, jdt),
        jnp.asarray(tau, jdt), jnp.asarray(tm), interpret=True)
    got = cauchy_matmul(t(w, dtype), t(src, dtype), t(av, dtype), t(tau, dtype),
                        torch.as_tensor(tm))
    assert _rel(got.numpy(), np.asarray(want)) < TOL[dtype]


def _stable_inputs(rng, n, r):
    src = np.sort(rng.normal(size=n))
    anchor = rng.integers(0, n, size=n)
    tau = rng.normal(size=n) * 1e-3
    valid = np.arange(n) < n - 2
    return rng.normal(size=(r, n)), src, anchor, tau, valid


@pytest.mark.parametrize("route", ["core", "ops"])
def test_stable_product_matches_reference(route):
    rng = np.random.default_rng(3)
    w, src, anchor, tau, valid = _stable_inputs(rng, 24, 7)
    jargs = (jnp.asarray(w), jnp.asarray(src), jnp.asarray(anchor), jnp.asarray(tau))
    targs = (t(w[None]), t(src[None]), torch.as_tensor(anchor[None]), t(tau[None]))
    vkw = dict(src_valid=jnp.asarray(valid), tgt_valid=jnp.asarray(valid))
    tkw = dict(src_valid=torch.as_tensor(valid[None]), tgt_valid=torch.as_tensor(valid[None]))
    if route == "core":
        want = RC.cauchy_matmul_stable(*jargs, **vkw)
        got = TC.cauchy_matmul_stable(*targs, **tkw)
    else:
        want = ROPS.cauchy_matmul_stable(*jargs, interpret=True, **vkw)
        got = ops.cauchy_matmul_stable(*targs, **tkw)
    assert _rel(got[0].numpy(), np.asarray(want)) < 1e-13


def test_colnorms_match_reference():
    rng = np.random.default_rng(4)
    _, src, anchor, tau, valid = _stable_inputs(rng, 20, 1)
    zhat = rng.normal(size=20)
    want = RC.cauchy_colnorms_stable(jnp.asarray(zhat), jnp.asarray(src), jnp.asarray(anchor),
                                     jnp.asarray(tau), src_valid=jnp.asarray(valid),
                                     tgt_valid=jnp.asarray(valid))
    got = TC.cauchy_colnorms_stable(t(zhat[None]), t(src[None]), torch.as_tensor(anchor[None]),
                                    t(tau[None]), src_valid=torch.as_tensor(valid[None]),
                                    tgt_valid=torch.as_tensor(valid[None]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-12, rtol=0)


def test_cpu_dispatch_takes_plain_and_counts_no_launch():
    rng = np.random.default_rng(5)
    w, src, av, tau, tm = (t(x) for x in _inputs(rng, 2, 3, 10, 9))
    before = _build.LAUNCHES["cauchy_matmul"]
    got = cauchy_matmul(w, src, av, tau, tm)
    assert _build.LAUNCHES["cauchy_matmul"] == before
    torch.testing.assert_close(got, cauchy_matmul_plain(w, src, av, tau, tm), rtol=0, atol=0)
