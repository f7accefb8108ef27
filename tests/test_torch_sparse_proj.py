"""Port parity for kernel F's plain version (``repro_torch.kernels.sparse_proj``).

``sparse_project_plain`` against the reference's interpret-mode Pallas
kernels (``sparse_project_pallas`` / ``sparse_project_pallas_batched``) and
its XLA segment sum, on the shapes of ``tests/test_sparse_proj.py``:
duplicate coordinates, padding entries, shared and per-batch coordinates,
the transposed call.  Limits relative to max |out|: f64 1e-13, f32 1e-5 (the
two sides sum the same terms, in orders that may differ).

The CUDA kernel itself runs only on a card (``tests/test_torch_cuda.py``);
here its index preparation is checked, and a loop that walks the prepared
segments exactly as the kernel does is held to the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch.kernels import sparse_proj as SP

RSP = ref("kernels.sparse_proj")
TOL = {np.float64: 1e-13, np.float32: 1e-5}
SHAPES = [(16, 16, 7, 4), (64, 48, 100, 8), (128, 96, 512, 16), (100, 90, 1300, 5)]


def _coo(rng, m, n, nnz, dup=True):
    """Random COO with duplicate coordinates (collisions must accumulate)."""
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    if dup and nnz >= 2:
        rows[1], cols[1] = rows[0], cols[0]
    return rows, cols, rng.normal(size=nnz)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("m,n,nnz,k", SHAPES)
def test_plain_matches_reference_kernel(m, n, nnz, k, dtype):
    rng = np.random.default_rng(23)
    rows, cols, vals = _coo(rng, m, n, nnz)
    vals, mat = vals.astype(dtype), rng.normal(size=(n, k)).astype(dtype)
    got = SP.sparse_project_plain(rows, cols, torch.as_tensor(vals), torch.as_tensor(mat), m)
    assert got.shape == (m, k) and got.dtype == torch.as_tensor(mat).dtype
    want = RSP.sparse_project_pallas(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                                     jnp.asarray(mat), m, interpret=True)
    assert _rel(got, want) <= TOL[dtype]
    xla = RSP.sparse_project_xla(rows, cols, jnp.asarray(vals), jnp.asarray(mat), m)
    assert _rel(got, xla) <= TOL[dtype]


@pytest.mark.parametrize("batch_coords", [True, False], ids=["per_batch", "shared"])
def test_batched_matches_reference_batched_kernel(batch_coords):
    rng = np.random.default_rng(24)
    m, n, nnz, k, bsz = 48, 40, 90, 6, 3
    rows, cols, _ = _coo(rng, m, n, nnz)
    bvals, bmat = rng.normal(size=(bsz, nnz)), rng.normal(size=(bsz, n, k))
    if batch_coords:  # different coordinates per member
        rows = np.stack([rng.integers(0, m, nnz) for _ in range(bsz)]).astype(np.int32)
        cols = np.stack([rng.integers(0, n, nnz) for _ in range(bsz)]).astype(np.int32)
    got = SP.sparse_project(rows, cols, torch.as_tensor(bvals), torch.as_tensor(bmat), m)
    assert got.shape == (bsz, m, k)
    want = RSP.sparse_project(rows, cols, jnp.asarray(bvals), jnp.asarray(bmat), m,
                              interpret=True)
    assert _rel(got, want) <= 1e-13
    for i in range(bsz):
        ri, ci = (rows[i], cols[i]) if batch_coords else (rows, cols)
        single = SP.sparse_project(ri, ci, torch.as_tensor(bvals[i]), torch.as_tensor(bmat[i]), m)
        torch.testing.assert_close(got[i], single, rtol=0, atol=0)


def test_shared_mat_under_batched_values_broadcasts():
    """Batched values against one (unbatched) block, as the sketch calls it."""
    rng = np.random.default_rng(25)
    m, n, nnz, k = 20, 16, 30, 4
    rows, cols, _ = _coo(rng, m, n, nnz)
    bvals, mat = rng.normal(size=(2, 3, nnz)), rng.normal(size=(n, k))
    got = SP.sparse_project(rows, cols, torch.as_tensor(bvals), torch.as_tensor(mat), m)
    assert got.shape == (2, 3, m, k)
    want = RSP.sparse_project_xla(rows, cols, jnp.asarray(bvals), jnp.asarray(mat), m)
    assert _rel(got, want) <= 1e-13


def test_padding_entries_are_noops():
    rng = np.random.default_rng(26)
    m, n, nnz, k, pad = 32, 24, 40, 4, 13
    rows, cols, vals = _coo(rng, m, n, nnz)
    mat = torch.as_tensor(rng.normal(size=(n, k)))
    base = SP.sparse_project_plain(rows, cols, torch.as_tensor(vals), mat, m)
    padded = SP.sparse_project_plain(np.concatenate([rows, np.zeros(pad, np.int32)]),
                                     np.concatenate([cols, np.zeros(pad, np.int32)]),
                                     torch.as_tensor(np.concatenate([vals, np.zeros(pad)])),
                                     mat, m)
    assert torch.equal(base, padded)


def test_transposed_projection_matches_reference():
    """Swapping rows and cols projects S^T: the sketch's co-range pass."""
    rng = np.random.default_rng(27)
    m, n, nnz, k = 40, 30, 60, 5
    rows, cols, vals = _coo(rng, m, n, nnz)
    mat = rng.normal(size=(m, k))
    got = SP.sparse_project_plain(cols, rows, torch.as_tensor(vals), torch.as_tensor(mat), n)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    assert _rel(got, dense.T @ mat) <= 1e-13
    want = RSP.sparse_project_pallas(jnp.asarray(cols), jnp.asarray(rows), jnp.asarray(vals),
                                     jnp.asarray(mat), n, interpret=True)
    assert _rel(got, want) <= 1e-13


def _walk_segments(perm, rowptr, op, out_rows):
    """Kernel F's loop on the CPU: for each batch member and destination row,
    walk the row's segment of ``perm`` and accumulate vals * mat[col]."""
    k = op.mat.shape[-1]
    out = torch.zeros((op.batch, out_rows, k), dtype=op.mat.dtype)
    pick = lambda x, b: x[b if x.shape[0] > 1 else 0]  # noqa: E731  (batch stride 0)
    for b in range(op.batch):
        pm, rp, cl, vl, mt = (pick(x, b) for x in (perm, rowptr, op.cols, op.vals, op.mat))
        for r in range(out_rows):
            acc = torch.zeros(k, dtype=op.mat.dtype)
            for p in range(int(rp[r]), int(rp[r + 1])):
                e = int(pm[p])
                acc = acc + vl[e] * mt[int(cl[e])]
            out[b, r] = acc
    return out


@pytest.mark.parametrize("case", ["single", "shared_coords", "per_batch_coords"])
def test_prepared_segments_reproduce_plain(case):
    """The index preparation the kernel reads (stable sort by destination
    row, row pointers): every entry lands in its row's segment in entry
    order, empty rows get empty segments, and walking the segments as the
    kernel does gives the plain version's result."""
    rng = np.random.default_rng(28)
    m, n, nnz, k, bsz = 12, 9, 40, 3, 3
    rows, cols, _ = _coo(rng, m - 2, n, nnz)          # rows m-2, m-1 stay empty
    if case == "per_batch_coords":
        rows = np.stack([rng.integers(0, m - 2, nnz) for _ in range(bsz)]).astype(np.int32)
        cols = np.stack([rng.integers(0, n, nnz) for _ in range(bsz)]).astype(np.int32)
    lead = () if case == "single" else (bsz,)
    vals = torch.as_tensor(rng.normal(size=lead + (nnz,)))
    mat = torch.as_tensor(rng.normal(size=lead + (n, k)))
    op = SP._operands(rows, cols, vals, mat)
    op = op._replace(rows=op.rows.to(torch.int32), cols=op.cols.to(torch.int32))
    perm, rowptr = SP.sparse_project_prep(op.rows, m)
    assert perm.dtype == rowptr.dtype == torch.int32
    assert rowptr.shape == (op.rows.shape[0], m + 1)
    for c in range(op.rows.shape[0]):
        r_c = op.rows[c].long()
        assert torch.equal(rowptr[c].long(), torch.searchsorted(r_c.sort().values,
                                                                torch.arange(m + 1)))
        for r in range(m):
            seg = perm[c, rowptr[c, r]:rowptr[c, r + 1]].long()
            assert torch.equal(seg, torch.nonzero(r_c == r)[:, 0])   # entry order
    assert int(rowptr[:, -1].min()) == nnz and torch.equal(rowptr[:, m - 2], rowptr[:, m])
    walked = _walk_segments(perm, rowptr, op, m).reshape(lead + (m, k))
    assert _rel(walked, SP.sparse_project_plain(rows, cols, vals, mat, m)) <= 1e-13


def test_operand_checks():
    rng = np.random.default_rng(29)
    rows, cols, vals = _coo(rng, 8, 6, 10)
    mat = torch.as_tensor(rng.normal(size=(6, 2)))
    with pytest.raises(ValueError, match="share a dtype"):
        SP.sparse_project(rows, cols, torch.as_tensor(vals, dtype=torch.float32), mat, 8)
    with pytest.raises(ValueError, match="nnz entries"):
        SP.sparse_project(rows[:-1], cols, torch.as_tensor(vals), mat, 8)
    SP.check_coords(rows, cols, 8, 6)
    with pytest.raises(ValueError, match="rows out of range"):
        SP.check_coords(rows, cols, 4, 6)
    with pytest.raises(ValueError, match="cols out of range"):
        SP.check_coords(rows, cols - 7, 8, 6)
    # CPU tensors never reach the kernel's wrapper: it refuses them
    with pytest.raises(ValueError, match="CUDA"):
        SP.sparse_project_cuda(rows, cols, torch.as_tensor(vals), mat, 8)
    with pytest.raises(NotImplementedError, match="f32 or f64"):
        SP.sparse_project_cuda(rows, cols, torch.as_tensor(vals).half(), mat.half(), 8)
