"""Differential op fuzz of the port: seed-pinned random ``Compose`` chains over
the whole op vocabulary (RankK, AppendRows, AppendCols, RemoveRows,
RemoveCols, DenseDelta, Sparse, Decay, Window) through
``repro_torch.api.apply`` on truncated states, held to the op's own
``apply_dense``.

The generator is ``tests/test_op_fuzz.py``'s numpy-Philox walk, ported to the
port's ops: it keeps the true rank of every intermediate matrix within the
state's rank budget, so the planner's result must match the dense reference
to ``ATOL`` (float64 drift over a chain is a few 1e-8; lowering faults show
at 1e-1).  No ``hypothesis`` is needed.
"""

import numpy as np
import pytest

from repro_torch import api
from repro_torch.updates import (
    AppendCols,
    AppendRows,
    Compose,
    Decay,
    DenseDelta,
    RankK,
    RemoveCols,
    RemoveRows,
    Sparse,
    Window,
)

ATOL = 1e-6
N_SEEDS = 12
CHAINS_PER_SEED = 9
GEOMETRIES = [(8, 7, 4), (7, 9, 4)]        # (m, n, state_rank)
DATA_RANK = 2
MAX_CHAIN = 3
MIN_DIM, MAX_DIM = 5, 12


def test_fuzz_covers_at_least_200_chains():
    assert N_SEEDS * CHAINS_PER_SEED * len(GEOMETRIES) >= 200


def _dense(op, a_mat):
    return op.apply_dense(a_mat).numpy()


def _sample_op(rng, m, n, dense, rank_used, state_rank):
    """One random op valid at (m, n): (op, new dense, new rank budget used)."""
    kinds = ["decay"]
    if rank_used < state_rank:
        kinds += ["rank_k", "dense_delta", "sparse"]
    if m + 1 <= MAX_DIM:
        kinds.append("append_rows")
    if n + 1 <= MAX_DIM:
        kinds.append("append_cols")
    if m - 1 >= max(MIN_DIM, state_rank) and m - 1 >= 1:
        kinds += ["remove_rows", "window"]
    if n - 1 >= max(MIN_DIM, state_rank):
        kinds.append("remove_cols")
    kind = kinds[rng.integers(len(kinds))]

    if kind == "decay":
        op = Decay(float(rng.uniform(0.5, 1.0)))
        return op, _dense(op, dense), rank_used
    if kind == "rank_k":
        op = RankK(rng.normal(size=(m, 1)), rng.normal(size=(n, 1)))
        return op, _dense(op, dense), rank_used + 1
    if kind == "dense_delta":
        op = DenseDelta(np.outer(rng.normal(size=m), rng.normal(size=n)), rank=1)
        return op, _dense(op, dense), rank_used + 1
    if kind == "sparse":
        nnz = 3
        rows = np.full(nnz, int(rng.integers(m)), dtype=np.int32)   # one row: rank 1
        cols = rng.choice(n, size=nnz, replace=False).astype(np.int32)
        op = Sparse(rows, cols, rng.normal(size=nnz), rank=1)
        return op, _dense(op, dense), rank_used + 1
    if kind == "append_rows":  # inside the current row space: rank unchanged
        op = AppendRows(rng.normal(size=(1, m)) @ dense)
        return op, _dense(op, dense), rank_used
    if kind == "append_cols":
        op = AppendCols(dense @ rng.normal(size=(n, 1)))
        return op, _dense(op, dense), rank_used
    if kind == "remove_rows":
        op = RemoveRows(int(rng.integers(m)))
        return op, _dense(op, dense), rank_used
    if kind == "remove_cols":
        op = RemoveCols(int(rng.integers(n)))
        return op, _dense(op, dense), rank_used
    op = Window(m - 1, lam=float(rng.uniform(0.5, 1.0)))   # evict the oldest row
    return op, _dense(op, dense), rank_used


def _sample_chain(rng, dense, state_rank):
    ops, rank_used = [], DATA_RANK
    for _ in range(int(rng.integers(1, MAX_CHAIN + 1))):
        op, dense, rank_used = _sample_op(rng, dense.shape[0], dense.shape[1], dense,
                                          rank_used, state_rank)
        ops.append(op)
    return (ops[0] if len(ops) == 1 else Compose(tuple(ops))), dense


def _top_r(dense, r):
    u, s, vt = np.linalg.svd(dense, full_matrices=False)
    return (u[:, :r] * s[:r]) @ vt[:r]


def _run_chains(seed: int) -> int:
    ran = 0
    for m, n, state_rank in GEOMETRIES:
        rng = np.random.Generator(np.random.Philox(seed * 1009 + m * 13 + n))
        base = rng.normal(size=(m, DATA_RANK)) @ rng.normal(size=(DATA_RANK, n))
        state = api.SvdState.from_dense(base, rank=state_rank, device="cpu")
        for c in range(CHAINS_PER_SEED):
            chain, want_dense = _sample_chain(rng, base, state_rank)
            out = api.apply(state, chain)
            assert out.shape == want_dense.shape, f"seed={seed} chain={c} spec={chain.spec()}"
            err = float(np.abs(out.materialize().numpy() - _top_r(want_dense, out.rank)).max())
            assert err < ATOL, (f"seed={seed} geom=({m},{n}) chain={c} err={err:.3e} "
                                f"spec={chain.spec()}")
            ran += 1
    return ran


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_fuzz_single_route(seed):
    assert _run_chains(seed) == CHAINS_PER_SEED * len(GEOMETRIES)


def test_fuzz_batched_route():
    """Stacked states over the batch-generic ops (removes, window, batched
    RankK): the stacked result matches each member applied alone."""
    bsz, m, n, r = 3, 8, 7, 4
    rng = np.random.Generator(np.random.Philox(77))
    for c in range(24):
        sts = [api.SvdState.from_dense(rng.normal(size=(m, DATA_RANK))
                                       @ rng.normal(size=(DATA_RANK, n)), rank=r, device="cpu")
               for _ in range(bsz)]
        stacked = api.SvdState.from_factors(
            *(np.stack([getattr(s, f).numpy() for s in sts]) for f in ("u", "s", "v")),
            device="cpu")
        pick = int(rng.integers(4))
        if pick == 0:
            op = RemoveRows(tuple(sorted(rng.choice(m, size=2, replace=False).tolist())))
        elif pick == 1:
            op = RemoveCols(int(rng.integers(n)))
        elif pick == 2:
            op = Window(m - 1, lam=float(rng.uniform(0.5, 1.0)))
        else:
            op = RankK(rng.normal(size=(bsz, m, 1)), rng.normal(size=(bsz, n, 1)))
        mat = api.apply(stacked, op).materialize().numpy()
        for j, st_j in enumerate(sts):
            op_j = op if pick != 3 else RankK(op.u[j], op.v[j])
            np.testing.assert_allclose(mat[j], api.apply(st_j, op_j).materialize().numpy(),
                                       atol=ATOL, err_msg=f"chain={c} member={j}")
