"""Port parity: the secular-solve kernel's plain version
(``repro_torch.kernels.secular_newton.secular_solve_plain``, reached on CPU
tensors through ``kernels.ops.secular_solve``) against the reference's
Pallas kernel run in interpret mode (``repro.kernels.ops.secular_solve``),
as ``tests/test_kernels.py`` runs it.  Tolerances are the reference test's:
1e-14 (f64) and 1e-5 (f32) absolute, on brackets no wider than 0.5.
Kernel D against this plain version on the card is in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref, t
from repro_torch.core import secular as S
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.secular_newton import secular_solve_plain

ROPS = ref("kernels.ops")
TOL = {torch.float64: 1e-14, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _random_brackets(rng, n, m):
    """``tests/test_kernels.py``'s inputs: poles in [0, 5], weights in
    [0.01, 1], rho 0.7, brackets [0, width] with width in [0.01, 0.5]."""
    dc = np.sort(rng.uniform(0, 5, n))
    zc2 = rng.uniform(0.01, 1, n)
    av = np.sort(rng.uniform(0, 5, m))
    return dc, zc2, 0.7, av, np.zeros(m), rng.uniform(0.01, 0.5, m)


@pytest.mark.parametrize("n,m", [(50, 50), (200, 200), (333, 150)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_secular_solve_matches_reference_kernel(n, m, dtype):
    rng = np.random.default_rng(n + m)
    dc, zc2, rho, av, lo, hi = _random_brackets(rng, n, m)
    jdt = JDT[dtype]
    want = np.asarray(ROPS.secular_solve(*(jnp.asarray(x, jdt) for x in (dc, zc2, rho, av, lo, hi)),
                                         interpret=True))
    before = dict(_build.LAUNCHES)
    got = ops.secular_solve(t(dc[None], dtype), t(zc2[None], dtype), t([rho], dtype),
                            t(av[None], dtype), t(lo[None], dtype), t(hi[None], dtype))
    assert _build.LAUNCHES == before                 # CPU tensors take the plain version
    assert got.dtype == dtype and got.shape == (1, m)
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL[dtype], rtol=0)


def test_batched_solve_equals_members_and_pads_to_zero():
    """A batch of three members equals each member alone, bitwise; a root
    with the bracket [0, 0] (the Pallas kernel's padding) comes out 0."""
    rng = np.random.default_rng(5)
    probs = [_random_brackets(rng, 64, 40) for _ in range(3)]
    dc, zc2, rho, av, lo, hi = (t(np.stack([np.asarray(p[k]) for p in probs]))
                                for k in range(6))
    hi[1, 7] = 0.0
    got = secular_solve_plain(dc, zc2, rho, av, lo, hi)
    assert float(got[1, 7]) == 0.0
    for i in range(3):
        one = secular_solve_plain(*(x[i:i + 1] for x in (dc, zc2, rho, av, lo, hi)))
        torch.testing.assert_close(got[i:i + 1], one, rtol=0, atol=0)
    torch.testing.assert_close(TREF.secular_solve_ref(dc, zc2, rho, av, lo, hi), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_bisect,n_newton", [(58, 4), (16, 6)])
def test_secular_solve_on_real_brackets(n_bisect, n_newton):
    """Brackets built as ``core.secular.secular_solve`` builds them, from a
    real (d, z, rho) with pole-hugging roots (tiny z components), at the
    kernel's default step counts and at the fused route's; the roots agree
    with the core solver's to rounding."""
    rng = np.random.default_rng(6)
    n = 120
    d = np.sort(rng.uniform(1, 9, n) ** 2)
    z = rng.normal(size=n)
    z[::9] *= 1e-5                                   # roots hugging their poles
    rho = 0.9
    br = S.secular_brackets(t(d[None]), t(z[None]), t([rho]), torch.tensor([n]))
    want = np.asarray(ROPS.secular_solve(*(jnp.asarray(x[0].numpy()) for x in
                                           (t(d[None]), br.zc2, t([rho]), br.anchor_vals,
                                            br.lo, br.hi)),
                                         n_bisect=n_bisect, n_newton=n_newton, interpret=True))
    got = ops.secular_solve(t(d[None]), br.zc2, t([rho]), br.anchor_vals, br.lo, br.hi,
                            n_bisect=n_bisect, n_newton=n_newton)
    width = float((br.hi - br.lo).abs().max())
    assert float(np.abs(got[0].numpy() - want).max()) / width < 1e-14
    roots = S.secular_solve(t(d[None]), t(z[None]), t([rho]), torch.tensor([n]))
    np.testing.assert_allclose(got[0].numpy(), roots.tau[0].numpy(), atol=1e-13 * width, rtol=0)
