"""Port parity for ``repro_torch.updates.sketch`` against ``repro.updates.sketch``.

Both sides get the same numpy inputs.  The test matrices Ω and Ψ must be
bitwise the reference's (same numpy Philox draws); everything else is held
by what eigenvector signs cannot change: ``u·s·vᵀ`` and σ, f64 within 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref
from _torch_updates_cases import lowrank, sparse_coo
from repro_torch.updates import sketch as SK

RSK = ref("updates.sketch")
ATOL = 1e-10


def _recon(u, s, v):
    u, s, v = (np.asarray(x, np.float64) for x in (u, s, v))
    return (u * s[..., None, :]) @ np.swapaxes(v, -1, -2)


def _assert_same_triplets(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), atol=atol, rtol=0)
    np.testing.assert_allclose(_recon(*got), _recon(*want), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,l,seed", [(30, 12, 0), (1024, 16, 1), (7, 3, 0)])
def test_test_matrices_are_bitwise_the_reference(n, l, seed, dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(RSK._test_matrix(n, l, jdt, seed=seed))
    got = SK._test_matrix(n, l, dtype, torch.device("cpu"), seed)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert SK._test_matrix(n, l, dtype, torch.device("cpu"), seed) is got  # moved once


def test_sample_count_matches_reference():
    for args in [(8, 8, 1024, 1024), (8, 8, 4, 6), (1, 0, 3, 3), (3, 2, 1, 9)]:
        assert SK.sample_count(*args) == RSK.sample_count(*args)


@pytest.mark.parametrize("data_rank,power_iters", [(4, 1), (30, 0), (30, 2)],
                         ids=["lowrank", "fullrank_p0", "fullrank_p2"])
def test_range_finder_matches_reference(data_rank, power_iters):
    rng = np.random.default_rng(21)
    delta = lowrank(rng, 30, 24, data_rank)
    q, b = SK.range_finder(torch.as_tensor(delta), 4, oversample=4, power_iters=power_iters)
    rq, rb = RSK.range_finder(jnp.asarray(delta), 4, oversample=4, power_iters=power_iters)
    assert q.shape == rq.shape and b.shape == rb.shape
    np.testing.assert_allclose((q @ b).numpy(), np.asarray(rq @ rb), atol=ATOL, rtol=0)
    if data_rank <= 8:  # exact regime
        np.testing.assert_allclose((q @ b).numpy(), delta, atol=ATOL, rtol=0)


def test_sketch_svd_matches_reference_single_and_batched():
    rng = np.random.default_rng(22)
    delta = lowrank(rng, 30, 24, 4)
    _assert_same_triplets(SK.sketch_svd(torch.as_tensor(delta), 4),
                          RSK.sketch_svd(jnp.asarray(delta), 4))
    batch = lowrank(rng, 9, 7, 2, lead=(3,))
    got = SK.sketch_svd(torch.as_tensor(batch), 3, oversample=2, power_iters=2)
    assert got[0].shape == (3, 9, 3) and got[2].shape == (3, 7, 3)
    _assert_same_triplets(got, RSK.sketch_svd(jnp.asarray(batch), 3, oversample=2,
                                              power_iters=2))
    np.testing.assert_allclose(_recon(*got), batch, atol=ATOL, rtol=0)


def test_factored_svd_matches_reference():
    rng = np.random.default_rng(23)
    qm = np.linalg.qr(rng.normal(size=(11, 3)))[0]
    b = rng.normal(size=(3, 8))
    got = SK.factored_svd(torch.as_tensor(qm), torch.as_tensor(b), k=3)
    _assert_same_triplets(got, RSK.factored_svd(jnp.asarray(qm), jnp.asarray(b), k=3))
    np.testing.assert_allclose(_recon(*got), qm @ b, atol=1e-12, rtol=0)
    padded = SK.factored_svd(torch.as_tensor(qm), torch.as_tensor(b), k=5)  # k > l: zeros
    assert padded[1].shape == (5,) and float(padded[1][3:].abs().max()) == 0.0


@pytest.mark.parametrize("k,oversample", [(5, 8), (3, 5), (2, 0)],
                         ids=["exact", "truncating", "no_oversample"])
def test_sparse_sketch_svd_matches_reference(k, oversample):
    rng = np.random.default_rng(24)
    m, n, nnz = 40, 30, 18
    rows, cols, vals = sparse_coo(rng, m, n, nnz, rows_used=5)
    got = SK.sparse_sketch_svd(rows, cols, torch.as_tensor(vals), m=m, n=n, k=k,
                               oversample=oversample)
    want = RSK.sparse_sketch_svd(rows, cols, jnp.asarray(vals), m=m, n=n, k=k,
                                 oversample=oversample)
    _assert_same_triplets(got, want)
    if k >= 5:  # exact regime: rank(S) <= 5 <= k <= l
        dense = np.zeros((m, n))
        np.add.at(dense, (rows, cols), vals)
        np.testing.assert_allclose(_recon(*got), dense, atol=ATOL, rtol=0)


def test_sparse_sketch_svd_batched_values_match_reference():
    """Batched values over shared coordinates, and per-batch coordinates."""
    rng = np.random.default_rng(25)
    m, n, nnz, bsz = 12, 10, 9, 3
    rows, cols, _ = sparse_coo(rng, m, n, nnz, rows_used=3)
    bvals = rng.normal(size=(bsz, nnz))
    got = SK.sparse_sketch_svd(rows, cols, torch.as_tensor(bvals), m=m, n=n, k=3)
    want = RSK.sparse_sketch_svd(rows, cols, jnp.asarray(bvals), m=m, n=n, k=3)
    assert got[0].shape == (bsz, m, 3)
    _assert_same_triplets(got, want)
    brows = np.stack([sparse_coo(rng, m, n, nnz, 3)[0] for _ in range(bsz)])
    bcols = np.stack([sparse_coo(rng, m, n, nnz, 3)[1] for _ in range(bsz)])
    _assert_same_triplets(SK.sparse_sketch_svd(brows, bcols, torch.as_tensor(bvals), m=m, n=n,
                                               k=3),
                          RSK.sparse_sketch_svd(brows, bcols, jnp.asarray(bvals), m=m, n=n,
                                                k=3))


def test_warmup_sketch_raises_by_name(monkeypatch):
    # warmup_sketch is ported (test_torch_warmup.py): it runs on the card by
    # default, and without one it raises by name rather than fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SK.warmup_sketch(m=4, n=4, k=1)
    assert SK.warmup_sketch(m=4, n=4, k=1, device="cpu")[1].shape == (1,)
