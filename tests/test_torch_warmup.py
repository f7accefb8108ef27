"""``api.warmup``, ``updates.warmup_plan`` and ``updates.warmup_sketch``
against the reference's.

Warming a (policy, geometry) pair must move the engine's cache accounting as
the reference's AOT warmup moves its plan cache (one miss and one entry,
then hits, the first real call of that geometry a hit), ``warmup_plan`` must
warm the geometries the reference's does and return the same list, and
``warmup_sketch`` must run the same sketch shapes.  On a card warming also
builds and loads the route's kernel libraries (``tests/test_torch_cuda.py``);
here it asks for the CPU, and asking for a card without one raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import api, updates as U
from repro_torch.api import cache
from repro_torch.api.update import engine_from_key
from repro_torch.core.engine import default_engine
from repro_torch.kernels import _build
from repro_torch.updates import sketch as SK

RAPI = ref("api")
RU = ref("updates")
RSK = ref("updates.sketch")
RENG = ref("core.engine")


def _engines(method):
    key = api.UpdatePolicy(method=method).engine_key(5)[:1]
    return default_engine(key[0]), RENG.default_engine(key[0])


@pytest.mark.parametrize("method", ["direct", "pallas", "fused"])
@pytest.mark.parametrize("geometry", [
    dict(m=6, n=8, rank=3),                   # truncated single
    dict(m=6, n=8, rank=3, batch=4),          # truncated batched
    dict(m=6, n=8, rank=3, batch=2, k=3),     # truncated rank-k batched
    dict(m=5, n=7),                           # full single
    dict(m=5, n=7, batch=2),                  # full batched
])
def test_api_warmup_moves_the_cache_like_reference(method, geometry):
    if method == "fused" and "rank" not in geometry and "batch" not in geometry:
        geometry = dict(geometry, batch=1)
    eng, reng = _engines(method)
    eng.cache_clear()
    reng.cache_clear()
    pol, rpol = api.UpdatePolicy(method=method), RAPI.UpdatePolicy(method=method)
    got = [api.warmup(pol, dtype=torch.float64, device="cpu", **geometry) for _ in range(2)]
    want = [RAPI.warmup(rpol, dtype=jnp.float64, **geometry) for _ in range(2)]
    assert tuple(got[0]) == tuple(want[0]) == (0, 1, 1)
    assert tuple(got[1]) == tuple(want[1]) == (1, 1, 1)


def test_warmed_geometry_is_a_hit_on_first_call():
    rng = np.random.default_rng(3)
    pol = api.UpdatePolicy(method="direct")
    eng = default_engine("direct")
    eng.cache_clear()
    api.warmup(pol, m=9, n=7, rank=3, batch=4, dtype=torch.float64, device="cpu")
    states = [api.SvdState.from_dense(rng.normal(size=(9, 7)), rank=3, device="cpu")
              for _ in range(4)]
    api.update_many(states, rng.normal(size=(4, 9)), rng.normal(size=(4, 7)), pol)
    assert tuple(eng.cache_info()) == (1, 1, 1)


def test_warmup_uses_the_storage_dtype():
    pol = api.UpdatePolicy(method="direct", storage_dtype="float32")
    eng = engine_from_key(pol, 4)
    eng.cache_clear()
    api.warmup(pol, m=6, n=8, rank=3, dtype=torch.float64, device="cpu")
    key = next(iter(eng._geometries))
    assert all(dt == torch.float32 for _, dt in key[1:])


def _ops(rng):
    return {
        "rank_k": U.RankK(rng.normal(size=(8, 2)), rng.normal(size=(6, 2))),
        "rank_k_scan": U.RankK(rng.normal(size=(8, 18)), rng.normal(size=(6, 18))),
        "append_dense": U.AppendRows(rng.normal(size=(2, 6))),
        "append_cols_factored": U.AppendCols.from_svd(np.linalg.qr(rng.normal(size=(8, 2)))[0],
                                                      np.array([2.0, 1.0]),
                                                      np.linalg.qr(rng.normal(size=(3, 2)))[0]),
        "dense_delta": U.DenseDelta(rng.normal(size=(8, 6)), rank=2),
        "sparse": U.Sparse(np.array([0, 1, 2], np.int32), np.array([1, 2, 3], np.int32),
                           rng.normal(size=3), rank=2),
        "remove": U.RemoveRows((1, 4)),
        "compose": U.Compose((U.Decay(0.9), U.AppendRows(rng.normal(size=(2, 6))),
                              U.Window(7, lam=0.9))),
    }


def _ref_op(op):
    import dataclasses

    if isinstance(op, U.Compose):
        return RU.Compose(tuple(_ref_op(c) for c in op.ops))
    return getattr(RU, type(op).__name__)(**{f.name: getattr(op, f.name)
                                             for f in dataclasses.fields(op)})


@pytest.mark.parametrize("kind", list(_ops(np.random.default_rng(0))))
@pytest.mark.parametrize("batch", [None, 2])
def test_warmup_plan_matches_reference(kind, batch):
    op = _ops(np.random.default_rng(0))[kind]
    pol, rpol = api.UpdatePolicy(method="direct"), RAPI.UpdatePolicy(method="direct")
    eng, reng = _engines("direct")
    eng.cache_clear()
    reng.cache_clear()
    got = U.warmup_plan(pol, op, m=8, n=6, rank=3, batch=batch, device="cpu")
    want = RU.warmup_plan(rpol, _ref_op(op), m=8, n=6, rank=3, batch=batch)
    assert got == [tuple(g) for g in want]
    assert tuple(eng.cache_info()) == tuple(reng.cache_info())


@pytest.mark.parametrize("nnz", [None, 5])
@pytest.mark.parametrize("batch", [None, 3])
def test_warmup_sketch_matches_reference(nnz, batch):
    kw = dict(m=9, n=7, k=2, oversample=3, nnz=nnz, batch=batch)
    got = SK.warmup_sketch(dtype=torch.float64, device="cpu", **kw)
    want = RSK.warmup_sketch(dtype=jnp.float64, **kw)
    assert [tuple(x.shape) for x in got] == [tuple(np.asarray(x).shape) for x in want]
    assert all(x.dtype == torch.float64 for x in got)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))   # zeros in, zero sigma


def test_warmup_on_a_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        api.warmup(api.UpdatePolicy(), m=4, n=6, rank=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SK.warmup_sketch(m=4, n=4, k=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        U.warmup_plan(api.UpdatePolicy(), U.DenseDelta(np.ones((4, 6)), rank=1), m=4, n=6,
                      rank=2)


def test_compilation_cache_points_the_build_root(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    assert cache.compilation_cache_entries(tmp_path / "missing") == 0
    assert api.enable_compilation_cache(tmp_path / "kc") == tmp_path / "kc"
    assert _build.BUILD_ROOT == tmp_path / "kc" and (tmp_path / "kc").is_dir()
    assert _build._build_dir().parent == tmp_path / "kc"
    (tmp_path / "kc" / "0123").mkdir()
    (tmp_path / "kc" / "0123" / "libnearfield.so").write_bytes(b"")
    assert cache.compilation_cache_entries(tmp_path / "kc") == 1
