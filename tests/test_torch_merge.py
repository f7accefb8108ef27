"""``repro_torch.dist.merge`` against the reference's ``repro.dist.merge``.

Row-partitioned shards, each reduced to its local truncated SVD, merged by
the log-depth rank-1-update tree: against the SVD of the concatenated matrix
at the reference's own tolerance (1e-6: trailing zero singular values come
back as ~1e-7 of deflation noise from any rank-1 merge), and against the
reference's ``merge_tree`` on the same numpy shards (f64).  Float32 shards
are held to the stacked matrix's top-r SVD at ten times float32's
sqrt(eps) (the same rule as 1e-6 in float64).  The cross-card form and the
collectives refuse by name (ROADMAP A7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import api, obs
from repro_torch.core.svd_update import TruncatedSvd
from repro_torch.dist import collectives, merge as merge_mod
from repro_torch.dist import distributed_merge, factor_wire_bytes, merge_pair, merge_tree
from repro_torch.obs import metrics as obs_metrics

RMERGE = ref("dist.merge")
RCOLL = ref("dist.collectives")
RTSVD = ref("core.svd_update").TruncatedSvd

RANK = 4
N = 12
# the reference's merge tolerance (tests/test_dist_merge.py)
ATOL = 1e-6
# float32: ten times the merge's noise floor sqrt(eps), relative
F32_LIMIT = 10 * float(np.finfo(np.float32).eps) ** 0.5


def _factors(mat: np.ndarray, r: int):
    u, s, vt = np.linalg.svd(mat, full_matrices=False)
    return u[:, :r].copy(), s[:r].copy(), vt[:r].T.copy()


def _tsvd(mat, r):
    return TruncatedSvd(*(torch.as_tensor(x) for x in _factors(mat, r)))


def _ref_tsvd(mat, r):
    return RTSVD(*(jnp.asarray(x) for x in _factors(mat, r)))


def _rank_r_reference(mat: np.ndarray, r: int):
    u, s, vt = np.linalg.svd(mat)
    return (u[:, :r] * s[:r]) @ vt[:r], s[:r]


def _rec(t):
    return np.asarray(t.u) @ np.diag(np.asarray(t.s)) @ np.asarray(t.v).T


def _same_as_reference(blocks, r=RANK):
    """The port's and the reference's merge of the same shards agree."""
    got = merge_tree([_tsvd(b, r) for b in blocks], rank=r)
    want = RMERGE.merge_tree([_ref_tsvd(b, r) for b in blocks], rank=r)
    np.testing.assert_allclose(_rec(got), _rec(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), atol=ATOL, rtol=0)
    assert tuple(got.u.shape) == tuple(want.u.shape)
    return got


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_merge_matches_concatenated_svd(n_shards):
    rng = np.random.default_rng(0)
    m_total = 80
    mat = rng.normal(size=(m_total, 3)) @ rng.normal(size=(N, 3)).T
    merged = _same_as_reference(np.array_split(mat, n_shards))
    opt, s_ref = _rank_r_reference(mat, RANK)
    np.testing.assert_allclose(_rec(merged), opt, atol=ATOL)
    np.testing.assert_allclose(merged.s.numpy(), s_ref, atol=ATOL)
    u, v = merged.u.numpy(), merged.v.numpy()
    np.testing.assert_allclose(u[:, :3].T @ u[:, :3], np.eye(3), atol=ATOL)
    np.testing.assert_allclose(v[:, :3].T @ v[:, :3], np.eye(3), atol=ATOL)
    assert u.shape == (m_total, RANK)


def _rotated_shards(rng, n_shards, m, n, r):
    """Factors of ``n_shards`` row blocks of one rank-r matrix: a common
    orthonormal V0 turned by each block's own rotation, singular values
    100 .. 1, so that the stacked singular values cluster."""
    def orth(*shape):
        return np.linalg.qr(rng.normal(size=shape))[0]

    v0, s = orth(n, r), np.geomspace(100.0, 1.0, r)
    return [(orth(m, r), s, v0 @ orth(r, r)) for _ in range(n_shards)]


@pytest.mark.parametrize("method", ["direct", "fused"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_merge_float32_matches_stacked_svd(n_shards, method):
    """Float32 shards of an exactly low-rank matrix: the merge's singular
    values, both subspaces and its reconstruction against the stacked
    matrix's top-r SVD (Algorithm 6.1 squares the spectrum, so float32 rank-1
    steps alone lose the left subspace over a merge's chain)."""
    rng = np.random.default_rng(11)
    r = 8
    factors = _rotated_shards(rng, n_shards, 16, 48, r)
    stacked = np.concatenate([(u * s) @ v.T for u, s, v in factors])
    uu, ss, vvt = np.linalg.svd(stacked, full_matrices=False)
    merged = merge_tree([TruncatedSvd(*(torch.as_tensor(x, dtype=torch.float32) for x in f))
                         for f in factors], policy=api.UpdatePolicy(method=method))
    assert merged.u.dtype == merged.s.dtype == merged.v.dtype == torch.float32
    u, s, v = (x.double().numpy() for x in merged)

    def span_err(want, got):
        q = np.linalg.qr(got)[0]
        return np.linalg.norm(q - want @ (want.T @ q)) / r ** 0.5

    assert np.max(np.abs(s - ss[:r]) / ss[:r]) <= F32_LIMIT
    assert span_err(uu[:, :r], u) <= F32_LIMIT
    assert span_err(vvt[:r].T, v) <= F32_LIMIT
    assert np.linalg.norm((u * s) @ v.T - stacked) / np.linalg.norm(stacked) <= F32_LIMIT


def test_merge_odd_shard_count():
    rng = np.random.default_rng(1)
    mat = rng.normal(size=(60, 3)) @ rng.normal(size=(N, 3)).T
    merged = _same_as_reference(np.array_split(mat, 3))
    np.testing.assert_allclose(_rec(merged), _rank_r_reference(mat, RANK)[0], atol=ATOL)


@pytest.mark.parametrize("n_shards", [3, 5, 6, 7])
def test_merge_non_pow2_stays_batched(n_shards, monkeypatch):
    """Equal-geometry lists of non-power-of-two length pad with zero shards,
    so every level runs batched: the pairwise fallbacks never fire."""
    def _boom(*a, **kw):
        raise AssertionError("pairwise merge fallback fired")

    monkeypatch.setattr(merge_mod, "merge_pair", _boom)
    monkeypatch.setattr(merge_mod, "merge_append", _boom)
    rng = np.random.default_rng(6)
    m_each = 12
    mat = rng.normal(size=(n_shards * m_each, 3)) @ rng.normal(size=(N, 3)).T
    blocks = [mat[i * m_each:(i + 1) * m_each] for i in range(n_shards)]
    merged = merge_mod.merge_tree([_tsvd(b, RANK) for b in blocks], rank=RANK)
    assert tuple(merged.u.shape) == (n_shards * m_each, RANK)
    opt, s_ref = _rank_r_reference(mat, RANK)
    np.testing.assert_allclose(_rec(merged), opt, atol=ATOL)
    np.testing.assert_allclose(merged.s.numpy(), s_ref, atol=ATOL)
    monkeypatch.undo()
    _same_as_reference(blocks)


def test_merge_mixed_geometry_still_works():
    """Unequal shard heights take the planner's AppendRows path."""
    rng = np.random.default_rng(7)
    mat = rng.normal(size=(50, 3)) @ rng.normal(size=(N, 3)).T
    merged = _same_as_reference([mat[:10], mat[10:30], mat[30:50]])
    np.testing.assert_allclose(_rec(merged), _rank_r_reference(mat, RANK)[0], atol=ATOL)


def test_merge_accepts_svdstate_and_preserves_container():
    rng = np.random.default_rng(8)
    mat = rng.normal(size=(40, 3)) @ rng.normal(size=(N, 3)).T
    legacy = [_tsvd(b, RANK) for b in np.array_split(mat, 4)]
    states = [api.as_state(t) for t in legacy]
    out_legacy = merge_tree(legacy, rank=RANK)
    out_state = merge_tree(states, rank=RANK)
    assert type(out_legacy).__name__ == "TruncatedSvd"
    assert isinstance(out_state, api.SvdState)
    assert torch.equal(out_legacy.u, out_state.u)


def test_merge_general_matrix_near_optimal():
    rng = np.random.default_rng(2)
    low = 10.0 * rng.normal(size=(80, RANK)) @ rng.normal(size=(N, RANK)).T
    mat = low + rng.normal(size=(80, N))
    merged = _same_as_reference(np.array_split(mat, 8))
    opt, s_ref = _rank_r_reference(mat, RANK)
    err = np.linalg.norm(mat - _rec(merged))
    assert err <= 1.25 * np.linalg.norm(mat - opt)
    np.testing.assert_allclose(merged.s.numpy()[:2], s_ref[:2], rtol=1e-3)


def test_merge_pair_and_append_match_reference():
    rng = np.random.default_rng(10)
    mat = rng.normal(size=(30, 3)) @ rng.normal(size=(N, 3)).T
    a, b = mat[:14], mat[14:]
    for fn, rfn in ((merge_pair, RMERGE.merge_pair), (merge_mod.merge_append, RMERGE.merge_append)):
        got = fn(_tsvd(a, RANK), _tsvd(b, RANK), rank=3)
        want = rfn(_ref_tsvd(a, RANK), _ref_tsvd(b, RANK), rank=3)
        np.testing.assert_allclose(_rec(got), _rec(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(_rec(got), _rank_r_reference(mat, 3)[0], atol=ATOL)


def test_merge_pair_rank_validation():
    rng = np.random.default_rng(3)
    a = _tsvd(rng.normal(size=(10, N)), 3)
    b = _tsvd(rng.normal(size=(10, N)), 3)
    with pytest.raises(ValueError, match="exceeds"):
        merge_pair(a, b, rank=5)
    with pytest.raises(ValueError, match="column space"):
        merge_pair(a, _tsvd(rng.normal(size=(10, N + 2)), 3))
    with pytest.raises(ValueError, match="exceeds the smallest shard rank"):
        merge_tree([a, b], rank=4)
    with pytest.raises(ValueError, match="at least one shard"):
        merge_tree([])


def test_service_merge_streams():
    """Per-worker shard streams (one with a pending pair) combine into the
    truncated SVD of the row-stacked matrix."""
    from repro_torch.serve import SvdService

    rng = np.random.default_rng(4)
    m = 16
    mat = rng.normal(size=(4 * m, 3)) @ rng.normal(size=(N, 3)).T
    svc = SvdService(max_batch=64)
    for w in range(4):
        svc.register(f"worker-{w}", _tsvd(mat[w * m:(w + 1) * m], RANK))
    a, b = rng.normal(size=(m,)), rng.normal(size=(N,))
    svc.enqueue("worker-2", a, b)
    merged = svc.merge_streams([f"worker-{w}" for w in range(4)], target="global")
    mat2 = mat.copy()
    mat2[2 * m:3 * m] += np.outer(a, b)
    np.testing.assert_allclose(_rec(merged), _rank_r_reference(mat2, RANK)[0], atol=1e-5)
    assert svc.pending("worker-2") == 0
    assert tuple(svc.state("global").u.shape) == (4 * m, RANK)


def test_merge_levels_trace_and_count_like_reference():
    """``merge_level`` spans and the merge counters, as the reference's."""
    rng = np.random.default_rng(12)
    mat = rng.normal(size=(48, 3)) @ rng.normal(size=(N, 3)).T
    blocks = np.array_split(mat, 6)
    robs = ref("obs")
    prev = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    rprev = robs.metrics.set_registry(robs.metrics.MetricsRegistry())
    try:
        for o in (obs, robs):
            o.enable()
            o.start_tracing()
            o.clear_trace()
        merge_tree([_tsvd(b, RANK) for b in blocks], rank=RANK)
        RMERGE.merge_tree([_ref_tsvd(b, RANK) for b in blocks], rank=RANK)
        levels = [[e["args"] for e in o.trace_events() if e["name"] == "merge_level"]
                  for o in (obs, robs)]
        assert levels[0] == levels[1] and len(levels[0]) == 3
        for name, labels in (("merge_levels", {}), ("merge_pairs", {}),
                             ("merge_wire_bytes", {"kind": "factor_allgather"}),
                             ("merge_wire_bytes", {"kind": "dense_allreduce"})):
            assert (obs.registry().get(name, **labels).value
                    == robs.registry().get(name, **labels).value)
    finally:
        for o in (obs, robs):
            o.stop_tracing()
            o.clear_trace()
            o.disable()
        obs_metrics.set_registry(prev)
        robs.metrics.set_registry(rprev)


@pytest.mark.parametrize("shape", [(64, 96, 4, 1, 4), (512, 768, 16, 8, 8)])
def test_factor_wire_bytes_matches_reference(shape):
    m, n, r, w, isz = shape
    assert factor_wire_bytes(m, n, r, n_workers=w, itemsize=isz) == RCOLL.factor_wire_bytes(
        m, n, r, n_workers=w, itemsize=isz)


def test_cross_card_forms_refuse_by_name():
    t = _tsvd(np.random.default_rng(5).normal(size=(10, N)), 3)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        distributed_merge(t, "data")
    for fn in (collectives.pmean_factor, collectives.psum_factor, collectives.all_gather_tsvd):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            fn(t.u, "data")
