"""The port's copy of the FAST baseline (``repro_torch.core.fast``, numpy
only) against the reference's ``repro.core.fast``: the same numbers, bitwise,
and the reference's claims (accurate in the paper's range, unstable beyond
it).  ``method="fast"`` stays refused at dispatch, as in the reference."""

import numpy as np
import pytest

from _torch_helpers import ref
from repro_torch import api
from repro_torch.core import fast

RFAST = ref("core.fast")


def _direct(u, lam, mu):
    return np.sum(u[None, :] / (lam[None, :] - mu[:, None]), axis=1)


@pytest.mark.parametrize("n", [4, 8, 16, 64])
def test_fast_matches_reference_bitwise(n):
    rng = np.random.default_rng(n)
    lam = np.sort(rng.uniform(0, 1, n))
    mu = np.sort(rng.uniform(0, 1, n)) + 1e-5
    u = rng.normal(size=n)
    np.testing.assert_array_equal(fast.fast_cauchy_matvec(u, lam, mu),
                                  RFAST.fast_cauchy_matvec(u, lam, mu))
    w = rng.normal(size=(3, n))
    np.testing.assert_array_equal(fast.fast_cauchy_matmul(w, lam, mu),
                                  RFAST.fast_cauchy_matmul(w, lam, mu))
    if n <= 16:   # the paper's range (n <= 35, Fig. 1)
        ref_ = _direct(u, lam, mu)
        assert np.max(np.abs(fast.fast_cauchy_matvec(u, lam, mu) - ref_)) / np.max(np.abs(ref_)) < 1e-6


def test_fast_instability_documented():
    rng = np.random.default_rng(0)
    errs = {}
    for n in (8, 64):
        lam = np.sort(rng.uniform(0, 1, n))
        mu = np.sort(rng.uniform(0, 1, n)) + 1e-5
        u = rng.normal(size=n)
        ref_ = _direct(u, lam, mu)
        errs[n] = np.max(np.abs(fast.fast_cauchy_matvec(u, lam, mu) - ref_)) / np.max(np.abs(ref_))
    assert errs[8] < 1e-6
    assert errs[64] > 1e3


def test_polynomial_helpers():
    np.testing.assert_allclose(fast.poly_from_roots(np.array([1.0, -2.0, 3.0])),
                               [6.0, -5.0, -2.0, 1.0], atol=1e-12)
    rng = np.random.default_rng(1)
    coeffs, pts = rng.normal(size=20), rng.uniform(-1, 1, 50)
    np.testing.assert_allclose(fast.multipoint_eval(coeffs, pts), np.polyval(coeffs[::-1], pts),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(fast.multipoint_eval(coeffs, pts),
                                  RFAST.multipoint_eval(coeffs, pts))


def test_fast_method_refused_at_dispatch():
    with pytest.raises(NotImplementedError, match="benchmark"):
        api.UpdatePolicy(method="fast").resolve_method(64)
