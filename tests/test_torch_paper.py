"""The paper's oracles through the port, on the CPU in f64.

Ported from the reference's own tests: ``tests/test_svd_update.py``
(Algorithm 6.1 against the paper's Table 2 and Eq. 32 error, rectangular
shapes, the kernel route against direct, 20 streaming updates, the truncated
update against the best rank r, and its two properties) and
``tests/test_secular.py`` (eigenvalues, deflation of duplicate poles and of
zero weights, interlacing, Loewner weights).  Each case runs the same numpy
inputs through ``repro_torch`` and through the reference (imported through
``_torch_helpers.ref``), and holds the port to the numpy truth at the
reference test's own tolerances and to the reference's output for the same
route.  The update cases run every route the port has, named explicitly:
``direct``, ``fmm`` (below 96 poles it falls back to direct, as the
reference's does), ``pallas``, ``fused`` and ``auto``.  The reference's
property tests draw their cases with hypothesis; here the same generators run
on fixed seeds, so every case runs wherever the suite does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref, t
from repro_torch import api, convert
from repro_torch.core import secular as S
from repro_torch.core.eigh_update import eigh_update

RAPI = ref("api")
RS = ref("core.secular")
REIGH = ref("core.eigh_update")
ROUTES = ["direct", "fmm", "pallas", "fused", "auto"]
# the paper's own accuracy (Table 2, Eq. 32 error); the update must beat it
# by six orders of magnitude
PAPER_TABLE2 = {10: 0.141, 20: 0.0838, 30: 0.0560, 40: 0.0624, 50: 0.0465}
# port against reference on the same route and inputs: |U S V^T - U' S' V'^T|
# and |s - s'| over sigma_max, at the reference's Table 2 bound
REF_TOL = 1e-10


def _setup(rng, m, n, lo=1.0, hi=9.0):
    """The paper's experimental set-up: a uniform(lo, hi) matrix, its SVD, a
    standard-normal pair."""
    a_mat = rng.uniform(lo, hi, size=(m, n))
    a = rng.normal(size=m)
    b = rng.normal(size=n)
    u, s, vt = np.linalg.svd(a_mat)
    return a_mat, u, s, vt.T, a, b


def _update(u, s, v, a, b, method):
    """The port's and the reference's ``api.update`` of the same factors,
    as numpy (u, s, v) each."""
    got = api.update(convert.state_from_arrays(u, s, v, device="cpu"), a, b,
                     api.UpdatePolicy(method=method))
    want = RAPI.update(RAPI.SvdState.from_factors(jnp.asarray(u), jnp.asarray(s), jnp.asarray(v)),
                       jnp.asarray(a), jnp.asarray(b), RAPI.UpdatePolicy(method=method))
    g = convert.state_to_arrays(got)
    return (g["u"], g["s"], g["v"]), tuple(np.asarray(getattr(want, k)) for k in ("u", "s", "v"))


def _recon(res, k):
    u, s, v = res
    return (u[:, :k] * s[:k]) @ v[:, :k].T


def _eq32_error(a_hat, res, m):
    """max |A_hat - U S V[:, :m]^T| / sigma_max(A_hat) (the paper's Eq. 32)."""
    smax = np.linalg.svd(a_hat, compute_uv=False)[0]
    return np.max(np.abs(a_hat - _recon(res, m))) / smax


def _assert_matches_reference(got, want, k):
    scale = float(want[1].max())
    assert np.max(np.abs(got[1][:k] - want[1][:k])) / scale < REF_TOL
    assert np.max(np.abs(_recon(got, k) - _recon(want, k))) / scale < REF_TOL


@pytest.mark.parametrize("n", sorted(PAPER_TABLE2))
@pytest.mark.parametrize("method", ROUTES)
def test_table2_accuracy_beats_paper(n, method):
    """``tests/test_svd_update.py:52``."""
    a_mat, u, s, v, a, b = _setup(np.random.default_rng(100 + n), n, n)
    got, want = _update(u, s, v, a, b, method)
    err = _eq32_error(a_mat + np.outer(a, b), got, n)
    assert err < 1e-10
    assert err < PAPER_TABLE2[n] * 1e-6
    _assert_matches_reference(got, want, n)


@pytest.mark.parametrize("m,n", [(30, 50), (64, 64), (128, 200)])
@pytest.mark.parametrize("method", ROUTES)
def test_rectangular_and_larger(m, n, method):
    """``tests/test_svd_update.py:63``: Eq. 32 error, singular values against
    a fresh SVD, orthogonality of both factors."""
    a_mat, u, s, v, a, b = _setup(np.random.default_rng(m * n), m, n)
    got, want = _update(u, s, v, a, b, method)
    a_hat = a_mat + np.outer(a, b)
    assert _eq32_error(a_hat, got, m) < 1e-9
    np.testing.assert_allclose(got[1], np.linalg.svd(a_hat, compute_uv=False), rtol=1e-9)
    assert np.max(np.abs(got[0].T @ got[0] - np.eye(m))) < 1e-10
    assert np.max(np.abs(got[2].T @ got[2] - np.eye(n))) < 1e-10
    _assert_matches_reference(got, want, m)


def test_kernel_method_matches_direct():
    """``tests/test_svd_update.py:79``: the Cauchy-kernel route
    (``pallas``) against ``direct`` at (96, 96)."""
    _, u, s, v, a, b = _setup(np.random.default_rng(96), 96, 96)
    r_dir, w_dir = _update(u, s, v, a, b, "direct")
    r_ker, w_ker = _update(u, s, v, a, b, "pallas")
    np.testing.assert_allclose(r_dir[1], r_ker[1], rtol=1e-12)
    np.testing.assert_allclose(r_dir[0], r_ker[0], atol=1e-11)
    _assert_matches_reference(r_dir, w_dir, 96)
    _assert_matches_reference(r_ker, w_ker, 96)


@pytest.mark.parametrize("method", ROUTES)
def test_repeated_updates_stay_orthogonal(method):
    """``tests/test_svd_update.py:90``: 20 successive rank-1 updates of a
    (40, 40) state, no re-factorisation."""
    n = 40
    rng = np.random.default_rng(40)
    a_mat, u, s, v, _, _ = _setup(rng, n, n)
    pol = api.UpdatePolicy(method=method)
    st = convert.state_from_arrays(u, s, v, device="cpu")
    acc = a_mat.copy()
    for _ in range(20):
        a, b = rng.normal(size=n), rng.normal(size=n)
        st = api.update(st, a, b, pol)
        acc = acc + np.outer(a, b)
    got = convert.state_to_arrays(st)
    assert np.max(np.abs(got["u"].T @ got["u"] - np.eye(n))) < 1e-8
    np.testing.assert_allclose(got["s"], np.linalg.svd(acc, compute_uv=False), rtol=1e-7)


def test_repeated_updates_match_reference():
    """The same 20 updates through the reference's direct route: the two
    chains end within 1e-10 of each other."""
    n = 40
    rng = np.random.default_rng(40)
    _, u, s, v, _, _ = _setup(rng, n, n)
    pairs = [(rng.normal(size=n), rng.normal(size=n)) for _ in range(20)]
    st = convert.state_from_arrays(u, s, v, device="cpu")
    rst = RAPI.SvdState.from_factors(jnp.asarray(u), jnp.asarray(s), jnp.asarray(v))
    for a, b in pairs:
        st = api.update(st, a, b, api.UpdatePolicy(method="direct"))
        rst = RAPI.update(rst, jnp.asarray(a), jnp.asarray(b), RAPI.UpdatePolicy(method="direct"))
    g = convert.state_to_arrays(st)
    want = tuple(np.asarray(getattr(rst, k)) for k in ("u", "s", "v"))
    _assert_matches_reference((g["u"], g["s"], g["v"]), want, n)


@pytest.mark.parametrize("method", ROUTES)
def test_truncated_streaming_matches_best_rank_r(method):
    """``tests/test_svd_update.py:107``: a rank-6 state of a (48, 32) matrix
    updated once matches the top 6 singular values of its low-rank part plus
    the pair."""
    m, n, r = 48, 32, 6
    rng = np.random.default_rng(6)
    u, s, vt = np.linalg.svd(rng.normal(size=(m, n)), full_matrices=False)
    ur, sr, vr = u[:, :r].copy(), s[:r].copy(), vt.T[:, :r].copy()
    a, b = rng.normal(size=m), rng.normal(size=n)
    got, want = _update(ur, sr, vr, a, b, method)
    sv = np.linalg.svd(ur * sr @ vr.T + np.outer(a, b), compute_uv=False)
    np.testing.assert_allclose(got[1], sv[:r], rtol=1e-10)
    assert np.max(np.abs(got[0].T @ got[0] - np.eye(r))) < 1e-10
    _assert_matches_reference(got, want, r)


# ``tests/test_svd_update.py:129``'s hypothesis draws (m in 5..40, n - m in
# 0..30, any seed), ten of them, fixed
PROPERTY_CASES = [(int(m), int(e), int(sd)) for m, e, sd in zip(
    np.random.default_rng(129).integers(5, 41, 10), np.random.default_rng(130).integers(0, 31, 10),
    np.random.default_rng(131).integers(0, 2 ** 31 - 1, 10))]


@pytest.mark.parametrize("case", range(len(PROPERTY_CASES)))
@pytest.mark.parametrize("method", ROUTES)
def test_property_svd_update_reconstructs(case, method):
    """``tests/test_svd_update.py:129``: a normal matrix of any shape with
    m <= n, Eq. 32 error below 1e-8; the direct route also against the
    reference's."""
    m, extra, seed = PROPERTY_CASES[case]
    n = m + extra
    rng = np.random.default_rng(seed)
    a_mat = rng.normal(size=(m, n))
    a, b = rng.normal(size=m), rng.normal(size=n)
    u, s, vt = np.linalg.svd(a_mat)
    got = api.update(convert.state_from_arrays(u, s, vt.T, device="cpu"), a, b,
                     api.UpdatePolicy(method=method))
    g = convert.state_to_arrays(got)
    res = (g["u"], g["s"], g["v"])
    assert _eq32_error(a_mat + np.outer(a, b), res, m) < 1e-8
    if method == "direct":
        _, want = _update(u, s, vt.T, a, b, method)
        _assert_matches_reference(res, want, m)


# ``tests/test_svd_update.py:143``'s draws (any seed, either sign of rho)
EIGH_CASES = [(int(sd), bool(i % 2)) for i, sd in
              enumerate(np.random.default_rng(143).integers(0, 2 ** 31 - 1, 10))]


@pytest.mark.parametrize("case", range(len(EIGH_CASES)))
@pytest.mark.parametrize("method", ["direct", "kernel"])
def test_property_eigh_update_invariants(case, method):
    """``tests/test_svd_update.py:143``: the updated eigenvectors stay
    orthonormal and the trace is kept (trace(B) = sum mu), for rho of either
    sign; and the reference's eigen-update on the same inputs."""
    seed, rho_pos = EIGH_CASES[case]
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 60))
    d = np.sort(rng.normal(size=n))
    z = rng.normal(size=n)
    rho = (1.0 if rho_pos else -1.0) * (abs(rng.normal()) + 0.05)
    u = np.linalg.qr(rng.normal(size=(n, n)))[0]
    mu, un = eigh_update(t(u[None]), t(d[None]), t(z[None]), t([rho]), rho_positive=rho_pos,
                         method=method)
    mu, un = mu[0].numpy(), un[0].numpy()
    assert np.max(np.abs(un.T @ un - np.eye(n))) < 1e-10
    np.testing.assert_allclose(mu.sum(), np.sum(d) + rho * np.dot(z, z), rtol=1e-10)
    r_mu, r_un = REIGH.eigh_update(jnp.asarray(u), jnp.asarray(d), jnp.asarray(z),
                                   jnp.asarray(rho), rho_positive=rho_pos)
    np.testing.assert_allclose(mu, np.asarray(r_mu), atol=1e-12 * max(1.0, np.abs(mu).max()))
    np.testing.assert_allclose(un, np.asarray(r_un), atol=1e-10)


def _solve_sorted(d, z, rho):
    """Deflate, solve the secular equation on the retained poles and return
    the sorted eigenvalues (deflated ones are their poles), with the
    deflation, the roots and the compacted poles."""
    dt, zt, rt = t(d[None]), t(z[None]), t([rho])
    defl = S.deflate(dt, zt, rt)
    dc = torch.gather(dt, 1, defl.compact)
    zc = torch.gather(defl.z, 1, defl.compact)
    roots = S.secular_solve(dc, zc, rt, defl.n_keep)
    mu = torch.sort(torch.where(roots.valid, roots.mu, dc), dim=1).values
    return mu[0].numpy(), defl, roots, dc, zc


def _reference_sorted(d, z, rho):
    dj, zj = jnp.asarray(d), jnp.asarray(z)
    defl = RS.deflate(dj, zj, jnp.asarray(rho))
    dc = dj[defl.compact]
    roots = RS.secular_solve(dc, defl.z[defl.compact], jnp.asarray(rho), defl.n_keep)
    return np.asarray(jnp.sort(jnp.where(roots.valid, roots.mu, dc)))


@pytest.mark.parametrize("n", [4, 17, 64, 256])
def test_eigenvalues_match_numpy(n):
    """``tests/test_secular.py:24``."""
    rng = np.random.default_rng(24 + n)
    d = np.sort(rng.uniform(-3, 3, n))
    z = rng.normal(size=n)
    rho = abs(rng.normal()) + 0.1
    truth = np.linalg.eigvalsh(np.diag(d) + rho * np.outer(z, z))
    mu, *_ = _solve_sorted(d, z, rho)
    atol = 1e-12 * max(1, np.abs(truth).max())
    np.testing.assert_allclose(mu, truth, rtol=0, atol=atol)
    np.testing.assert_allclose(mu, _reference_sorted(d, z, rho), rtol=0, atol=atol)


def test_duplicate_poles_deflate():
    """``tests/test_secular.py:34``: 15 equal poles merge into one."""
    n = 60
    rng = np.random.default_rng(34)
    d = np.sort(rng.uniform(0, 1, n))
    d[10:25] = d[10]
    z = rng.normal(size=n)
    rho = 0.5
    truth = np.linalg.eigvalsh(np.diag(d) + rho * np.outer(z, z))
    mu, defl, _, _, _ = _solve_sorted(d, z, rho)
    assert int(defl.n_keep[0]) <= n - 14
    np.testing.assert_allclose(mu, truth, atol=1e-12)
    np.testing.assert_allclose(mu, _reference_sorted(d, z, rho), atol=1e-12)


def test_zero_z_entries_deflate():
    """``tests/test_secular.py:46``: every fourth weight zero."""
    n = 40
    rng = np.random.default_rng(46)
    d = np.sort(rng.uniform(0, 1, n))
    z = rng.normal(size=n)
    z[::4] = 0.0
    rho = 1.3
    truth = np.linalg.eigvalsh(np.diag(d) + rho * np.outer(z, z))
    mu, defl, _, _, _ = _solve_sorted(d, z, rho)
    assert int(defl.n_keep[0]) == n - len(z[::4])
    np.testing.assert_allclose(mu, truth, atol=1e-12)
    np.testing.assert_allclose(mu, _reference_sorted(d, z, rho), atol=1e-12)


def test_interlacing_exact():
    """``tests/test_secular.py:58``: for rho > 0, d_i < mu_i < d_{i+1} on the
    retained set (the last root below d_k + rho |z|^2)."""
    n = 100
    rng = np.random.default_rng(58)
    d = np.sort(rng.uniform(-1, 1, n))
    z = rng.normal(size=n) + 0.1
    rho = 0.7
    _, defl, roots, dc, zc = _solve_sorted(d, z, rho)
    k = int(defl.n_keep[0])
    mu = roots.mu[0, :k].numpy()
    dc, zc = dc[0].numpy(), zc[0].numpy()
    assert np.all(mu > dc[:k])
    upper = np.append(dc[1:k], dc[k - 1] + rho * float(np.sum(zc[:k] ** 2)) + 1e-12)
    assert np.all(mu <= upper)
    want = RS.secular_solve(jnp.asarray(dc), jnp.asarray(zc), jnp.asarray(rho), k)
    np.testing.assert_allclose(mu, np.asarray(want.mu)[:k], rtol=0, atol=1e-12)


def test_loewner_orthogonality_weights():
    """``tests/test_secular.py:78``: zhat from the computed roots reproduces
    the weights (|zhat| = |zc| to 1e-8, signs kept), and the reference's
    zhat on the same roots."""
    n = 50
    rng = np.random.default_rng(78)
    d = np.sort(rng.uniform(0, 2, n))
    z = rng.normal(size=n)
    rho = 0.9
    _, _, roots, dc, zc = _solve_sorted(d, z, rho)
    zhat = S.loewner_zhat(dc, zc, t([rho]), roots)[0].numpy()
    zc_ = zc[0].numpy()
    np.testing.assert_allclose(np.abs(zhat), np.abs(zc_), rtol=1e-8)
    assert np.all(np.sign(zhat) == np.sign(zc_))
    dj = jnp.asarray(dc[0].numpy())
    r_roots = RS.secular_solve(dj, jnp.asarray(zc_), jnp.asarray(rho), int(roots.valid[0].sum()))
    r_zhat = np.asarray(RS.loewner_zhat(dj, jnp.asarray(zc_), jnp.asarray(rho), r_roots))
    np.testing.assert_allclose(zhat, r_zhat, rtol=0, atol=1e-12)
