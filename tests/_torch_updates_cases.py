"""Shared cases of the structured-update parity tests
(``test_torch_updates.py``, ``test_torch_apply_routes.py``): one op of
each kind built from the same numpy data in the port's and in the
reference's ``updates``, states built from the same numpy factors, and the
comparisons (not collected itself)."""

import numpy as np
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import api, convert, updates as U

RAPI = ref("api")
RU = ref("updates")

ATOL = 1e-10
TRUTH_ATOL = 1e-8
BSZ = 3


def lowrank(rng, m, n, r, lead=()):
    return rng.normal(size=lead + (m, r)) @ rng.normal(size=lead + (r, n))


def full_factors(rng, m, n):
    u, s, vt = np.linalg.svd(rng.uniform(1, 9, (m, n)))
    return u, s, vt.T.copy()


def trunc_factors(rng, m, n, r, data_rank=2):
    u, s, vt = np.linalg.svd(lowrank(rng, m, n, data_rank), full_matrices=False)
    return u[:, :r].copy(), s[:r].copy(), vt[:r].T.copy()


def states(factors):
    """The same numpy factors (a list of triples: stacked if several) as a
    reference state and a port state on the CPU."""
    u, s, v = (np.stack(x) if len(factors) > 1 else x[0] for x in zip(*factors))
    rs = RAPI.SvdState.from_factors(jnp.asarray(u), jnp.asarray(s), jnp.asarray(v))
    return rs, convert.state_from_arrays(u, s, v, device="cpu")


def recon(u, s, v):
    k = s.shape[-1]
    return (np.asarray(u) * np.asarray(s)[..., None, :]) @ np.swapaxes(np.asarray(v)[..., :k],
                                                                         -1, -2)


def compare(got, want, atol=ATOL):
    g = convert.state_to_arrays(got)
    w = {k: np.asarray(getattr(want, k)) for k in ("u", "s", "v")}
    assert g["u"].shape == w["u"].shape and g["v"].shape == w["v"].shape
    np.testing.assert_allclose(g["s"], w["s"], atol=atol, rtol=0, err_msg="s")
    np.testing.assert_allclose(recon(g["u"], g["s"], g["v"]), recon(w["u"], w["s"], w["v"]),
                               atol=atol, rtol=0, err_msg="u s v^T")


def top_r(dense, r):
    u, s, vt = np.linalg.svd(dense, full_matrices=False)
    return (u[..., :r] * s[..., None, :r]) @ vt[..., :r, :]


def assert_truth(state_np, op, out):
    """``out`` against the top-rank reconstruction of ``op.apply_dense(A)``."""
    dense = op.apply_dense(recon(*state_np)).numpy()
    got = convert.state_to_arrays(out)
    np.testing.assert_allclose(recon(got["u"], got["s"], got["v"]),
                               top_r(dense, got["s"].shape[-1]), atol=TRUTH_ATOL, rtol=0)


def sparse_coo(rng, m, n, nnz, rows_used, lead=()):
    rows = rng.choice(m, size=rows_used, replace=False)[rng.integers(0, rows_used, nnz)]
    cols = rng.integers(0, n, nnz)
    rows[1], cols[1] = rows[0], cols[0]      # a duplicate accumulates
    return rows.astype(np.int32), cols.astype(np.int32), rng.normal(size=lead + (nnz,))


def make_op(M, kind, m, n, lead=()):
    """The op ``kind`` at geometry (m, n) built in module ``M`` (the port's or
    the reference's ``updates``) from numpy data drawn from a fixed seed, so
    both modules get the same op."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "rank_k":
        return M.RankK(rng.normal(size=lead + (m, 3)), rng.normal(size=lead + (n, 3)))
    if kind == "rank_k_scan":
        # k = 18 >= _SCAN_MIN: one update_rank_k step; every partial sum of
        # the 18 pairs has rank <= 2, so a truncated state holds it exactly
        return M.RankK(lowrank(rng, m, 18, 2, lead) * 0.3, lowrank(rng, n, 18, 2, lead) * 0.3)
    if kind == "dense_delta":
        return M.DenseDelta(lowrank(rng, m, n, 2, lead), rank=2)
    if kind == "sparse":
        return M.Sparse(*sparse_coo(rng, m, n, 7, 2, lead), rank=2)
    if kind == "decay":
        return M.Decay(0.7)
    if kind == "append_rows":
        return M.AppendRows(lowrank(rng, 3, n, 1))
    if kind == "append_rows_factored":
        return M.AppendRows.from_svd(np.linalg.qr(rng.normal(size=(3, 2)))[0],
                                     np.abs(rng.normal(size=2)) + 1,
                                     np.linalg.qr(rng.normal(size=(n, 2)))[0])
    if kind == "append_cols":
        return M.AppendCols(lowrank(rng, m, 2, 1))
    if kind == "remove_rows":
        return M.RemoveRows((1, m - 1))
    if kind == "remove_cols":
        return M.RemoveCols(n - 2)
    if kind == "window":
        return M.Window(m - 2, lam=0.9)
    if kind == "compose_full":
        return M.Compose((M.Decay(0.9), M.RankK(rng.normal(size=(m, 2)), rng.normal(size=(n, 2))),
                          M.DenseDelta(lowrank(rng, m, n, 1), rank=1),
                          M.Sparse(*sparse_coo(rng, m, n, 5, 1), rank=1)))
    if kind == "compose_trunc":
        return M.Compose((M.Decay(0.8), M.AppendRows(lowrank(rng, 2, n, 1)),
                          M.RankK(rng.normal(size=(m + 2, 1)), rng.normal(size=(n, 1))),
                          M.RemoveCols(1), M.Sparse(*sparse_coo(rng, m + 2, n - 1, 4, 1),
                                                    rank=1)))
    raise ValueError(kind)


FULL_KINDS = ["rank_k", "rank_k_scan", "dense_delta", "sparse", "decay", "compose_full"]
TRUNC_KINDS = ["rank_k", "rank_k_scan", "dense_delta", "sparse", "decay", "append_rows",
               "append_rows_factored", "append_cols", "remove_rows", "remove_cols", "window",
               "compose_trunc"]
STACKED_KINDS = ["rank_k", "dense_delta", "sparse", "decay", "remove_rows", "remove_cols",
                 "window"]
REMOVE_KINDS = ("remove_rows", "remove_cols", "window", "compose_trunc")


def data_rank_for(kind, rank):
    """Rank of the state's data: 2 (headroom, so that the dense truth is
    exact), or the state's full rank for the pure downdates.  A structurally
    zero singular value comes back from a rank-1 update as ~sqrt(eps)·σ_max
    noise (the square root of the eigenvalue's rounding), which differs
    between any two implementations, so parity at 1e-10 needs none."""
    return rank if kind in ("remove_rows", "remove_cols", "window") else 2


def method_for(kind, method):
    # an explicit "fused" is honoured on downdates, where the reference's own
    # fused route may pair u and v inconsistently (ROADMAP queue C): use direct
    return "direct" if kind in REMOVE_KINDS else method


def run_parity(kind, factors, method, lead=()):
    rs, ts = states(factors)
    m, n = ts.m, ts.n
    pol = dict(method=method_for(kind, method))
    want = RAPI.apply(rs, make_op(RU, kind, m, n, lead), RAPI.UpdatePolicy(**pol))
    op = make_op(U, kind, m, n, lead)
    got = api.apply(ts, op, api.UpdatePolicy(**pol))
    compare(got, want)
    return ts, op, got
