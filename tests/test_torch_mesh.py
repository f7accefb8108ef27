"""The mesh rows of the port: ``dist.mesh.Mesh``, ``dist.sharding``'s batch
rules, the engine's four batched entry points under ``mesh=``, ``api.update``
/ ``update_many`` / ``update_rank_k`` / ``warmup`` under ``policy.mesh``, and
the service under a mesh.

A mesh splits a batch into contiguous slices, one per entry of its batch
axis, each run with the same route on that entry's device.  On the CPU every
entry is the one CPU device and each slice runs the plain bodies, which give
an update the same bits whatever the batch it rides in, so a mesh of one
entry and one of four (B = 13: padding) must give the local call's bits, on
full and truncated states, on ``direct`` and ``fused``.  The batch rules are
held to the reference's on the same inputs.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import api
from repro_torch.core.engine import SvdEngine, default_engine
from repro_torch.core.svd_update import TruncatedSvd
from repro_torch.dist import (
    AXIS_SIZES,
    Mesh,
    batch_pad,
    batch_pspecs,
    batch_sharding,
    make_host_mesh,
)
from repro_torch.serve import SvdService

RSHARD = ref("dist.sharding")

B = 13
CPU = torch.device("cpu")
MESHES = {"one": make_host_mesh(1, device="cpu"), "four": make_host_mesh(4, device="cpu")}


def _exact(got, want):
    for f in ("u", "s", "v"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def _stack_inputs(full, k=None, seed=3, m=6, n=9, r=3):
    """B stacked f64 states (full (m, n) or rank r) and B pairs (k-row
    blocks of pairs when ``k`` is given)."""
    rng = np.random.default_rng(seed)
    sts = [np.linalg.svd(rng.normal(size=(m, n)), full_matrices=full) for _ in range(B)]
    if full:
        u, s, v = (np.stack(x) for x in zip(*[(a, b, c.T) for a, b, c in sts]))
    else:
        u, s, v = (np.stack(x) for x in zip(*[(a[:, :r], b[:r], c[:r].T) for a, b, c in sts]))
    lead = (B,) if k is None else (B, k)
    a, b = rng.normal(size=lead + (m,)), rng.normal(size=lead + (n,))
    return [torch.as_tensor(np.ascontiguousarray(x)) for x in (u, s, v, a, b)]


# -- the Mesh ----------------------------------------------------------------------


def test_mesh_geometry_equality_and_refusals():
    m = Mesh([["cpu", "cpu"], ["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
    assert m.shape == {"data": 3, "model": 2} and m.size == 6
    assert m.devices.shape == (3, 2)
    assert m.batch_devices("data") == (CPU,) * 3
    assert m.batch_devices("model") == (CPU,) * 2
    assert m == Mesh(m.devices, ("data", "model")) and hash(m) == hash(Mesh(m.devices, m.axis_names))
    assert m != Mesh(m.devices, ("model", "data"))
    assert make_host_mesh(4, device="cpu").shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="no axis"):
        m.axis_size("pod")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu", "cpu"], ("data", "model"))
    with pytest.raises(AttributeError):
        m.axis_names = ("x", "y")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_host_mesh(2)


@pytest.mark.parametrize("where", ["policy", "state", "engine", "sharding"])
def test_anything_but_a_mesh_is_refused(where):
    st = api.SvdState.from_dense(np.eye(3, 4), rank=2, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        if where == "policy":
            api.UpdatePolicy(mesh=object())
        elif where == "state":
            api.SvdState.from_factors(st.u, st.s, st.v, device="cpu", mesh="data")
        elif where == "engine":
            t = TruncatedSvd(st.u[None], st.s[None], st.v[None])
            default_engine("direct").update_truncated_batch(
                t, torch.ones(1, 3, dtype=torch.float64), torch.ones(1, 4, dtype=torch.float64),
                mesh=jax.make_mesh((1,), ("data",)))
        else:
            batch_sharding(object())


def test_batch_rules_match_reference():
    assert AXIS_SIZES == RSHARD.AXIS_SIZES
    batch = {"x": np.zeros((4, 3)), "y": [np.zeros((2,)), np.zeros(())]}
    for multi_pod in (False, True):
        want = RSHARD.batch_pspecs(jax.tree.map(jnp.asarray, batch), multi_pod=multi_pod)
        got = batch_pspecs({"x": torch.zeros(4, 3), "y": [torch.zeros(2), torch.zeros(())]},
                           multi_pod=multi_pod)
        assert got["x"] == tuple(want["x"]) and got["y"][0] == tuple(want["y"][0])
        assert got["y"][1] == tuple(want["y"][1]) == ()
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    for b in (1, 5, 13, 16):
        assert batch_pad(b, MESHES["one"]) == RSHARD.batch_pad(b, jmesh) == 0
        assert batch_pad(b, MESHES["four"]) == (-b) % 4
    with pytest.raises(ValueError, match="no axis"):
        batch_pad(3, MESHES["four"], "pod")


# -- the engine's four mesh rows ------------------------------------------------------


ROWS = ["update_batch", "update_truncated_batch", "update_rank_k_batch",
        "update_truncated_rank_k_batch"]


def _row_call(eng, row, inputs, **kw):
    u, s, v, a, b = inputs
    if "truncated" in row:
        return getattr(eng, row)(TruncatedSvd(u, s, v), a, b, **kw)
    return getattr(eng, row)(u, s, v, a, b, **kw)


@pytest.mark.parametrize("method", ["direct", "fused"])
@pytest.mark.parametrize("row", ROWS)
def test_engine_mesh_rows_equal_local_bits(row, method):
    inputs = _stack_inputs("truncated" not in row, k=3 if "rank_k" in row else None)
    eng = default_engine(method)
    want = _row_call(eng, row, inputs)
    for name, mesh in MESHES.items():
        got = _row_call(eng, row, inputs, mesh=mesh)
        _exact(got, want)
        assert got.u.shape[0] == B, name
    # the engine-wide sharding sends a call without mesh= the same way
    sharded = SvdEngine(method=method, sharding=batch_sharding(MESHES["four"]))
    _exact(_row_call(sharded, row, inputs), want)


def test_mesh_calls_key_the_cache_by_mesh_and_padded_batch():
    eng = SvdEngine(method="direct")
    inputs = _stack_inputs(False)
    _row_call(eng, "update_truncated_batch", inputs, mesh=MESHES["four"])
    _row_call(eng, "update_truncated_batch", inputs, mesh=MESHES["four"])
    _row_call(eng, "update_truncated_batch", inputs, mesh=MESHES["one"])
    _row_call(eng, "update_truncated_batch", inputs)
    assert eng.cache_info() == (1, 3, 3)
    shard_keys = [k for k in eng._geometries if k[0] == "shard"]
    assert {k[1] for k in shard_keys} == set(MESHES.values())
    assert {k[2] for k in shard_keys} == {"data"}
    # the padded batch: 13 rounds up to 16 on four entries, stays 13 on one
    assert {(k[1].shape["data"], k[4][0][0]) for k in shard_keys} == {(4, 16), (1, 13)}
    with pytest.raises(ValueError, match="no axis"):
        _row_call(eng, "update_truncated_batch", inputs, mesh=MESHES["four"], batch_axis="pod")


# -- the api under policy.mesh --------------------------------------------------------


def _api_case(full, seed):
    rng = np.random.default_rng(seed)
    sts = [api.SvdState.from_dense(rng.normal(size=(6, 9)), None if full else 3, device="cpu")
           for _ in range(B)]
    return sts, [rng.normal(size=6) for _ in range(B)], [rng.normal(size=9) for _ in range(B)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("method", ["direct", "fused"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "truncated"])
def test_api_routes_under_policy_mesh_equal_local_bits(full, method, mesh_name):
    sts, A, Bv = _api_case(full, 11 + full)
    pol = api.UpdatePolicy(method=method)
    mpol = pol.replace(mesh=MESHES[mesh_name])
    for got, want in zip(api.update_many(sts, A, Bv, mpol), api.update_many(sts, A, Bv, pol)):
        _exact(got, want)
    stacked = api.SvdState(*(torch.stack([getattr(s, f) for s in sts]) for f in ("u", "s", "v")))
    a, b = torch.as_tensor(np.stack(A)), torch.as_tensor(np.stack(Bv))
    _exact(api.update(stacked, a, b, mpol), api.update(stacked, a, b, pol))
    rng = np.random.default_rng(5)
    ka, kb = torch.as_tensor(rng.normal(size=(B, 2, 6))), torch.as_tensor(rng.normal(size=(B, 2, 9)))
    _exact(api.update_rank_k(stacked, ka, kb, mpol), api.update_rank_k(stacked, ka, kb, pol))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_apply_many_under_policy_mesh_equals_local_bits(mesh_name):
    """Structured updates ride the mesh rows too: a RankK and a Decay on 13
    truncated states, each rank-1 step of the schedule split over the mesh."""
    from repro_torch.updates import Compose, Decay, RankK

    sts, _, _ = _api_case(False, 21)
    rng = np.random.default_rng(22)
    ops = [Compose((Decay(0.9), RankK(rng.normal(size=(6, 2)), rng.normal(size=(9, 2)))))
           for _ in range(B)]
    pol = api.UpdatePolicy(method="direct")
    got = api.apply_many(sts, ops, pol.replace(mesh=MESHES[mesh_name]))
    for g, w in zip(got, api.apply_many(sts, ops, pol)):
        _exact(g, w)


def test_state_mesh_is_placement_metadata():
    sts, A, Bv = _api_case(False, 4)
    mesh = MESHES["four"]
    stacked = api.SvdState(*(torch.stack([getattr(s, f) for s in sts]) for f in ("u", "s", "v")),
                           mesh=mesh)
    a, b = torch.as_tensor(np.stack(A)), torch.as_tensor(np.stack(Bv))
    eng = api.engine_for(api.UpdatePolicy(method="direct"), stacked)
    eng.cache_clear()
    out = api.update(stacked, a, b, api.UpdatePolicy(method="direct"))
    assert out.mesh is mesh and out.truncate(2).mesh is mesh and out.to(torch.float32).mesh is mesh
    assert any(k[0] == "shard" for k in eng._geometries)     # the state's mesh routed it
    _exact(out, api.update(stacked.replace(mesh=None), a, b, api.UpdatePolicy(method="direct")))
    singles = [s.replace(mesh=mesh) for s in sts]
    assert all(o.mesh is mesh for o in api.update_many(singles, A, Bv))


def test_warmup_under_a_mesh_warms_the_mesh_row():
    pol = api.UpdatePolicy(method="direct", mesh=MESHES["four"])
    eng = api.engine_for(pol, api.SvdState.from_dense(np.eye(6, 9), rank=3, device="cpu"))
    eng.cache_clear()
    api.warmup(pol, m=6, n=9, rank=3, batch=B, dtype=torch.float64, device="cpu")
    assert eng.cache_info() == (0, 1, 1)
    sts, A, Bv = _api_case(False, 6)
    api.update_many(sts, A, Bv, pol)
    assert eng.cache_info() == (1, 1, 1)


# -- the service under a mesh ---------------------------------------------------------


def _service(mesh, seed=9, streams=7, rounds=3):
    rng = np.random.default_rng(seed)
    svc = SvdService(max_batch=8, policy=api.UpdatePolicy(method="fused", mesh=mesh))
    for i in range(streams):
        svc.register(f"s{i}", api.SvdState.from_dense(rng.normal(size=(6, 9)), 3, device="cpu"))
    for _ in range(rounds):
        for i in range(streams):
            svc.enqueue(f"s{i}", rng.normal(size=6), rng.normal(size=9))
    svc.flush()
    for i in range(streams):
        for _ in range(3):
            svc.enqueue(f"s{i}", rng.normal(size=6), rng.normal(size=9))
    while svc.pending():
        svc.flush_round(max_depth=2)
    svc.drain()
    return svc


def test_service_under_a_mesh_equals_the_plain_service(tmp_path):
    plain = _service(None)
    for mesh in MESHES.values():
        svc = _service(mesh)
        for sid in plain._streams:
            _exact(svc.state(sid), plain.state(sid))
        assert svc.stats.scan_rounds == plain.stats.scan_rounds > 0
    # restore: a mesh grafts onto the recorded policy without a warning and
    # warms the warmed set under it; a snapshot taken under a mesh and
    # restored without one warns
    svc.save(tmp_path, step=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, back = SvdService.restore(tmp_path, mesh=MESHES["four"], device="cpu")
    assert back.policy.mesh == MESHES["four"] and back.policy.method == "fused"
    assert dict(back.snapshot().policy_spec)["had_mesh"] is True
    with pytest.warns(UserWarning, match="no mesh"):
        _, bare = SvdService.restore(tmp_path, device="cpu")
    assert bare.policy.mesh is None
