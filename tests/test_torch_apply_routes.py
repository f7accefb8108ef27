"""Port parity for ``api.apply`` on single truncated states and on stacked
(full and truncated) states, one op of every kind under an explicit method,
against the reference, the dense truth and (stacked) each member alone (the
cases of ``_torch_updates_cases``), and the errors of plans that a state's
geometry refuses."""

import numpy as np
import pytest

from _torch_updates_cases import (
    ATOL, BSZ, RAPI, REMOVE_KINDS, RU, STACKED_KINDS, TRUNC_KINDS, assert_truth, data_rank_for,
    full_factors, method_for, recon, run_parity, states, trunc_factors,
)
from repro_torch import api, convert, updates as U


@pytest.mark.parametrize("kind", TRUNC_KINDS)
@pytest.mark.parametrize("method", ["direct", "fused"])
def test_apply_truncated_single_matches_reference(kind, method):
    f = trunc_factors(np.random.default_rng(2), 7, 10, 5, data_rank_for(kind, 5))
    ts, op, got = run_parity(kind, [f], method)
    assert_truth(f, op, got)


@pytest.mark.parametrize("route,kind", [("truncated", k) for k in STACKED_KINDS]
                         + [("full", k) for k in STACKED_KINDS if k not in REMOVE_KINDS])
def test_apply_stacked_matches_reference(route, kind):
    rng = np.random.default_rng(3)
    factors = [(full_factors(rng, 5, 7) if route == "full"
                else trunc_factors(rng, 8, 7, 4, data_rank_for(kind, 4))) for _ in range(BSZ)]
    method = "fused" if route == "truncated" else "direct"
    _, op, got = run_parity(kind, factors, method, lead=(BSZ,) if kind != "decay" else ())
    g = convert.state_to_arrays(got)
    for j, f in enumerate(factors):  # the stacked result equals each member alone
        one = _member(op, j) if kind in ("rank_k", "dense_delta", "sparse") else op
        alone = convert.state_to_arrays(api.apply(
            convert.state_from_arrays(*f, device="cpu"), one,
            api.UpdatePolicy(method=method_for(kind, method))))
        np.testing.assert_allclose(recon(g["u"][j], g["s"][j], g["v"][j]),
                                   recon(alone["u"], alone["s"], alone["v"]), atol=ATOL, rtol=0)


def _member(op, j):
    """Member ``j`` of a batched op, as an unbatched op."""
    if isinstance(op, U.RankK):
        return U.RankK(op.u[j], op.v[j])
    if isinstance(op, U.DenseDelta):
        return U.DenseDelta(op.delta[j], rank=op.rank)
    return U.Sparse(op.rows, op.cols, op.vals[j], rank=op.rank)


def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("kind,geom", [
    ("append_full", "full"), ("remove_full", "full"), ("window_full", "full"),
    ("remove_range", "trunc"), ("remove_rank", "trunc"), ("window_rank", "trunc"),
])
def test_invalid_plans_raise_the_reference_errors(kind, geom):
    rng = np.random.default_rng(13)
    f = full_factors(rng, 4, 6) if geom == "full" else trunc_factors(rng, 6, 5, 4)
    rs, ts = states([f])
    make = {"append_full": lambda M: M.AppendRows(np.zeros((2, 6))),
            "remove_full": lambda M: M.RemoveRows(0),
            "window_full": lambda M: M.Window(3),
            "remove_range": lambda M: M.RemoveRows(6),
            "remove_rank": lambda M: M.RemoveCols((0, 1)),
            "window_rank": lambda M: M.Window(3)}[kind]
    want = _raised(lambda: RAPI.apply(rs, make(RU)))
    got = _raised(lambda: api.apply(ts, make(U)))
    assert want is not None and got == want
