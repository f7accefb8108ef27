"""Port parity for ``repro_torch.updates`` and ``api.apply`` / ``apply_many`` /
``update_rank_k`` against the reference ``repro.updates`` / ``repro.api``
(truncated and stacked states: ``test_torch_apply_routes.py``).

Both sides get the same numpy factors and op data and run an explicit
``method`` (never ``auto``, whose route depends on the reference's TPU gate).
Results are compared by what the arbitrary parts of a state cannot change
(reconstruction ``u·s·vᵀ`` and σ; ``v[:, :m]`` for full states), f64 within
1e-10, and against the dense truth ``op.apply_dense(A)`` within 1e-8.  The
schedules of ``lower``, the schedule-cache counts and the error messages of
invalid ops are compared too.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref
from _torch_updates_cases import (
    ATOL, BSZ, FULL_KINDS, RAPI, RU, TRUNC_KINDS, TRUTH_ATOL, compare, full_factors, make_op,
    recon, run_parity, sparse_coo, states, trunc_factors,
)
from repro_torch import api, convert, updates as U
from repro_torch.core.engine import default_engine
from repro_torch.updates import planner as P

RP = ref("updates.planner")


@pytest.mark.parametrize("kind", FULL_KINDS)
@pytest.mark.parametrize("method", ["direct", "fused"])
def test_apply_full_single_matches_reference(kind, method):
    f = full_factors(np.random.default_rng(1), 6, 9)
    ts, op, got = run_parity(kind, [f], method)
    dense = op.apply_dense(ts.materialize()).numpy()
    g = convert.state_to_arrays(got)
    np.testing.assert_allclose(recon(g["u"], g["s"], g["v"]), dense, atol=TRUTH_ATOL, rtol=0)


@pytest.mark.parametrize("route", ["full", "truncated"])
@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("k", [3, 18])
def test_update_rank_k_matches_reference(route, stacked, k):
    rng = np.random.default_rng(4)
    count = BSZ if stacked else 1
    factors = [(full_factors(rng, 5, 8) if route == "full" else trunc_factors(rng, 9, 8, 4))
               for _ in range(count)]
    rs, ts = states(factors)
    lead = (BSZ,) if stacked else ()
    A, B = 0.3 * rng.normal(size=lead + (k, ts.m)), 0.3 * rng.normal(size=lead + (k, ts.n))
    pol = dict(method="direct")
    want = RAPI.update_rank_k(rs, jnp.asarray(A), jnp.asarray(B), RAPI.UpdatePolicy(**pol))
    got = api.update_rank_k(ts, A, B, api.UpdatePolicy(**pol))
    compare(got, want)
    if route == "full":
        np.testing.assert_allclose(got.d_left.numpy(), np.asarray(want.d_left), atol=ATOL * 1e2,
                                   rtol=0)


def test_update_rank_k_truncate_to_runs_pair_by_pair():
    rng = np.random.default_rng(5)
    f = trunc_factors(rng, 9, 8, 5, data_rank=4)
    rs, ts = states([f])
    A, B = rng.normal(size=(3, 9)), rng.normal(size=(3, 8))
    pol = dict(method="direct", truncate_to=3)
    want = RAPI.update_rank_k(rs, jnp.asarray(A), jnp.asarray(B), RAPI.UpdatePolicy(**pol))
    got = api.update_rank_k(ts, A, B, api.UpdatePolicy(**pol))
    assert got.rank == 3
    compare(got, want)


def test_apply_many_matches_reference_and_batches_across_streams():
    """Mixed ops and geometries, and B streams x rank-k: k batched engine
    calls on one geometry entry, not B*k single ones."""
    rng = np.random.default_rng(6)
    factors = [trunc_factors(rng, 6, 8, 4, 1) for _ in range(4)] + [trunc_factors(rng, 5, 9, 3, 1)]
    kinds = ["rank_k", "rank_k", "rank_k", "compose_mix", "decay"]

    def ops(M):
        r = np.random.default_rng(60)
        out = [M.RankK(r.normal(size=(6, 3)), r.normal(size=(8, 3))) for _ in range(3)]
        out.append(M.Compose((M.Decay(0.5), M.RankK(r.normal(size=(6, 3)),
                                                     r.normal(size=(8, 3))))))
        return out + [M.Decay(0.25)]

    pol = dict(method="direct", deflate_rtol=7.25e-13)   # a private engine configuration
    eng = default_engine("direct", deflate_rtol=7.25e-13)
    eng.cache_clear()
    r_states = [RAPI.SvdState.from_factors(*map(jnp.asarray, f)) for f in factors]
    t_states = [convert.state_from_arrays(*f, device="cpu") for f in factors]
    want = RAPI.apply_many(r_states, ops(RU), RAPI.UpdatePolicy(**pol))
    # the reference's own tests/test_updates.py counts this configuration's
    # cache from empty: leave its engine as this test found it
    ref("core.engine").default_engine("direct", deflate_rtol=7.25e-13).cache_clear()
    got = api.apply_many(t_states, ops(U), api.UpdatePolicy(**pol))
    assert len(got) == len(kinds)
    # the three plain RankK share one plan: one stacked geometry, 3 calls; the
    # Compose has its own plan and runs alone (3 single calls)
    info = eng.cache_info()
    assert (info.entries, info.misses, info.hits) == (2, 2, 4)
    for g, w in zip(got, want):
        compare(g, w)


def test_sparse_padding_is_a_noop_and_keys_its_own_schedule():
    rng = np.random.default_rng(8)
    _, ts = states([full_factors(rng, 6, 9)])
    rows, cols, vals = sparse_coo(rng, 6, 9, 7, 2)
    base_op = U.Sparse(rows, cols, vals, rank=2)
    pad = 5
    padded = U.Sparse(np.concatenate([rows, np.zeros(pad, np.int32)]),
                      np.concatenate([cols, np.zeros(pad, np.int32)]),
                      np.concatenate([vals, np.zeros(pad)]), rank=2)
    assert padded.spec() != base_op.spec()
    pol = api.UpdatePolicy(method="direct")
    np.testing.assert_allclose(api.apply(ts, padded, pol).materialize().numpy(),
                               api.apply(ts, base_op, pol).materialize().numpy(),
                               atol=ATOL, rtol=0)


# -- op algebra, schedules, caches, errors -------------------------------------------


ALL_KINDS = sorted(set(FULL_KINDS + TRUNC_KINDS))


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_ops_match_reference_semantics_specs_and_schedules(kind):
    m, n = (6, 9) if kind in FULL_KINDS else (7, 10)
    op, rop = make_op(U, kind, m, n), make_op(RU, kind, m, n)
    a_mat = np.random.default_rng(9).normal(size=(m, n))
    np.testing.assert_allclose(op.apply_dense(a_mat).numpy(), np.asarray(rop.apply_dense(a_mat)),
                               atol=1e-13, rtol=0)
    assert op.spec() == rop.spec() and op.out_shape(m, n) == rop.out_shape(m, n)
    spec = op.spec()
    assert U.spec_from_json(json.loads(json.dumps(U.spec_to_json(spec)))) == spec
    skel = U.skeleton_from_spec(spec)
    assert type(skel) is type(op)
    assert type(RU.skeleton_from_spec(spec)).__name__ == type(op).__name__
    f = trunc_factors(np.random.default_rng(9), m, n, 5)
    rs, ts = states([f])
    pol = dict(sketch_oversample=4, sketch_power_iters=2)
    assert P.lower(op, ts, api.UpdatePolicy(**pol)) == RP.lower(rop, rs, RAPI.UpdatePolicy(**pol))
    if kind in FULL_KINDS:
        rs, ts = states([full_factors(np.random.default_rng(9), m, n)])
        assert P.lower(op, ts) == RP.lower(rop, rs)


def test_batched_sparse_dense_semantics_match_reference():
    rng = np.random.default_rng(10)
    rows, cols, bvals = sparse_coo(rng, 5, 6, 8, 3, lead=(2,))
    rows, cols = np.stack([rows, rows[::-1]]), np.stack([cols, cols])   # per-member coordinates
    a_mat = rng.normal(size=(5, 6))
    got = U.Sparse(rows, cols, bvals).apply_dense(a_mat)
    want = RU.Sparse(rows, cols, bvals).apply_dense(a_mat)
    assert got.shape == (2, 5, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-14, rtol=0)


def test_schedule_cache_counts_and_sketch_keys():
    rng = np.random.default_rng(11)
    _, ts = states([trunc_factors(rng, 6, 8, 4)])
    op1 = U.RankK(rng.normal(size=(6, 2)), rng.normal(size=(8, 2)))
    op2 = U.RankK(rng.normal(size=(6, 2)), rng.normal(size=(8, 2)))
    U.lower(op1, ts)
    before = U.schedule_cache_info()
    plan = U.lower(op2, ts)                 # same spec and geometry: a hit
    after = U.schedule_cache_info()
    assert (after.hits, after.misses, after.entries) == (before.hits + 1, before.misses,
                                                          before.entries)
    assert [s[0] for s in plan] == ["rank1", "rank1"]
    p1 = api.UpdatePolicy(method="direct")
    p2 = api.UpdatePolicy(method="direct", sketch_oversample=4, sketch_power_iters=2)
    assert p1.engine_key(5) != p2.engine_key(5) and p2.sketch_params == (4, 2)
    U.lower(op1, ts, p2)
    assert U.schedule_cache_info().entries == after.entries + 1
    U.schedule_cache_clear()
    assert U.schedule_cache_info() == (0, 0, 0)


def test_decay_is_free_of_engine_dispatches():
    rng = np.random.default_rng(12)
    _, ts = states([trunc_factors(rng, 6, 8, 4)])
    pol = api.UpdatePolicy(method="direct", deflate_rtol=3.25e-13)
    eng = default_engine("direct", deflate_rtol=3.25e-13)
    before = eng.cache_info()
    out = api.apply(ts, U.Decay(0.5), pol)
    assert eng.cache_info() == before
    assert torch.equal(out.s, 0.5 * ts.s) and torch.equal(out.u, ts.u)


def _raised(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", [
    lambda M: M.AppendRows(),
    lambda M: M.AppendRows(rows=np.zeros((1, 2)), u=np.zeros((1, 1)), s=np.zeros(1),
                           v=np.zeros((2, 1))),
    lambda M: M.AppendCols(),
    lambda M: M.DenseDelta(np.zeros((2, 2)), rank=0),
    lambda M: M.Sparse(np.zeros(1), np.zeros(1), np.zeros(1), rank=0),
    lambda M: M.Compose((M.Decay(0.5), "not-an-op")),
    lambda M: M.RemoveRows(()),
    lambda M: M.RemoveRows((1, 1)),
    lambda M: M.RemoveCols(-1),
    lambda M: M.RemoveCols("ab"),
    lambda M: M.Window(0),
    lambda M: M.RemoveRows(5).apply_dense(np.zeros((3, 2))),
    lambda M: M.skeleton_from_spec(("nope",)),
], ids=["append_rows_none", "append_rows_both", "append_cols_none", "dense_rank0",
        "sparse_rank0", "compose_not_op", "remove_empty", "remove_dup", "remove_negative",
        "remove_not_int", "window0", "remove_out_of_range", "bad_spec"])
def test_invalid_ops_raise_the_reference_errors(case):
    got, want = _raised(lambda: case(U)), _raised(lambda: case(RU))
    assert want is not None and got is not None
    assert got == want


def test_apply_many_rejects_stacked_states_and_mismatched_lengths():
    st = api.SvdState(u=torch.zeros(2, 4, 3), s=torch.ones(2, 3), v=torch.zeros(2, 5, 3))
    with pytest.raises(ValueError, match="unbatched"):
        api.apply_many([st], [U.Decay(0.5)])
    with pytest.raises(ValueError, match="1 states but 2 ops"):
        api.apply_many([st], [U.Decay(0.5), U.Decay(0.5)])


def test_api_exposes_apply_and_unported_warmups_raise(monkeypatch):
    assert "apply" in api.__all__ and "apply_many" in api.__all__
    assert set(U.__all__) == set(RU.__all__)
    # warmup_plan is ported (test_torch_warmup.py): on the card by default,
    # and without one it raises by name rather than fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        U.warmup_plan(api.UpdatePolicy(), U.RankK(np.zeros((4, 1)), np.zeros((6, 1))),
                      m=4, n=6, rank=2)
    assert U.warmup_plan(api.UpdatePolicy(), U.Decay(0.5), m=4, n=6, device="cpu") == []
