"""Port parity: the secular machinery (``repro_torch.kernels.secular_body``,
``repro_torch.core.secular``) against the JAX reference, f64, atol 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref, t
from repro_torch.core import secular as S
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.secular_body import secular_iterate

ATOL = 1e-12
RSB = ref("kernels.secular_body")
RS = ref("core.secular")
RREF = ref("kernels.ref")


def _secular_inputs(rng, n):
    """Poles, weights and left-anchored brackets of a well-posed problem."""
    dc = np.sort(rng.normal(size=n)) * 3.0
    z = rng.normal(size=n)
    rho = 0.7
    gaps = np.diff(dc)
    hi = np.concatenate([gaps, [rho * np.sum(z * z)]])
    return dc, z * z, rho, dc.copy(), np.zeros(n), hi


@pytest.mark.parametrize("poles_axis", [0, 1])
@pytest.mark.parametrize("n", [5, 17])
def test_secular_iterate_matches_reference(poles_axis, n):
    rng = np.random.default_rng(100 + n)
    dc, zc2, rho, av, lo, hi = _secular_inputs(rng, n)
    diff = dc[:, None] - av[None, :]                   # [pole j, root i]
    if poles_axis == 1:
        diff = diff.T.copy()
    want = RSB.secular_iterate(jnp.asarray(diff), jnp.asarray(zc2), jnp.asarray(rho),
                               jnp.asarray(lo), jnp.asarray(hi), n_bisect=16, n_newton=6,
                               poles_axis=poles_axis)
    got = secular_iterate(t(diff[None]), t(zc2[None]), t([rho]), t(lo[None]), t(hi[None]),
                          n_bisect=16, n_newton=6, poles_axis=poles_axis)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _deflation_problem(rng, n):
    d = np.sort(rng.normal(size=n))
    d[3] = d[2]                                         # exact duplicate
    d[6] = d[5] + 1e-17                                 # near duplicate
    z = rng.normal(size=n)
    z[1] = 1e-20                                        # tiny weight
    return d, z, 1.3


def test_deflate_matches_reference():
    rng = np.random.default_rng(7)
    d, z, rho = _deflation_problem(rng, 12)
    want = RS.deflate(jnp.asarray(d), jnp.asarray(z), jnp.asarray(rho))
    got = S.deflate(t(d[None]), t(z[None]), t([rho]))
    for name in ("z", "givens_c", "givens_s"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    for name in ("keep", "n_keep", "givens_a", "givens_b", "any_rot", "compact"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_apply_givens_columns_matches_reference():
    rng = np.random.default_rng(8)
    d, z, rho = _deflation_problem(rng, 12)
    w = rng.normal(size=(4, 12))
    rd = RS.deflate(jnp.asarray(d), jnp.asarray(z), jnp.asarray(rho))
    want = RS.apply_givens_columns(jnp.asarray(w), rd.givens_a, rd.givens_b, rd.givens_c,
                                   rd.givens_s, rd.any_rot)
    td = S.deflate(t(d[None]), t(z[None]), t([rho]))
    got = S.apply_givens_columns(t(w[None]), td.givens_a, td.givens_b, td.givens_c,
                                 td.givens_s, td.any_rot)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_secular_solve_and_loewner_match_reference(seed):
    rng = np.random.default_rng(seed)
    d, z, rho = _deflation_problem(rng, 12)
    rd = RS.deflate(jnp.asarray(d), jnp.asarray(z), jnp.asarray(rho))
    dc = np.asarray(d)[np.asarray(rd.compact)]
    zc = np.asarray(rd.z)[np.asarray(rd.compact)]
    n_keep = int(rd.n_keep)
    want = RS.secular_solve(jnp.asarray(dc), jnp.asarray(zc), jnp.asarray(rho), rd.n_keep)
    got = S.secular_solve(t(dc[None]), t(zc[None]), t([rho]), torch.tensor([n_keep]))
    for name in ("mu", "tau"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.anchor[0].numpy(), np.asarray(want.anchor))
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(S.mu_minus_d(got, t(dc[None]))[0].numpy(),
                               np.asarray(RS.mu_minus_d(want, jnp.asarray(dc))), atol=ATOL, rtol=0)

    zh_want = RS.loewner_zhat(jnp.asarray(dc), jnp.asarray(zc), jnp.asarray(rho), want)
    zh_got = S.loewner_zhat(t(dc[None]), t(zc[None]), t([rho]), got)
    np.testing.assert_allclose(zh_got[0].numpy(), np.asarray(zh_want), atol=ATOL, rtol=0)


def test_secular_solve_ref_matches_reference():
    """``kernels.ref.secular_solve_ref`` (roots on the last axis, 58 + 4
    steps) against the reference's oracle of the same name."""
    rng = np.random.default_rng(9)
    dc, zc2, rho, av, lo, hi = _secular_inputs(rng, 13)
    want = RREF.secular_solve_ref(*map(jnp.asarray, (dc, zc2, rho, av, lo, hi)))
    got = TREF.secular_solve_ref(t(dc[None]), t(zc2[None]), t([rho]), t(av[None]), t(lo[None]),
                                 t(hi[None]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_secular_batch_equals_loop():
    """The batch dimension is independent problems: a stacked solve equals
    solving each problem alone."""
    rng = np.random.default_rng(3)
    probs = [_secular_inputs(rng, 9) for _ in range(3)]
    stack = [np.stack(x) for x in zip(*probs)]
    dc, zc2, rho, av, lo, hi = stack
    diff = dc[:, :, None] - av[:, None, :]
    got = secular_iterate(t(diff), t(zc2), t(rho), t(lo), t(hi), n_bisect=16, n_newton=6)
    for i in range(3):
        one = secular_iterate(t(diff[i:i + 1]), t(zc2[i:i + 1]), t(rho[i:i + 1]),
                              t(lo[i:i + 1]), t(hi[i:i + 1]), n_bisect=16, n_newton=6)
        np.testing.assert_allclose(got[i].numpy(), one[0].numpy(), atol=ATOL, rtol=0)
