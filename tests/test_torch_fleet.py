"""``repro_torch.fleet`` against the reference's ``repro.fleet``.

The reference fleet's own shape (``tests/test_fleet.py``: 5 streams, m8 n10
r3, f64, ``direct``), the same numpy states and events on both sides.
Placement hashes like the reference's; a fleet ``query`` equals the port's
single-service settle to the bit at every shard count and the reference
fleet's query to 1e-12 of sigma_max; continuous batching keeps every
stream's order; ``FleetSnapshot`` v8 files restore in both packages with
their leaves bitwise, pending events and pending deletions included, and an
elastic regroup moves leaves bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import _tree, api, convert, obs
from repro_torch.dist import make_host_mesh
from repro_torch.fleet import (
    FLEET_SNAPSHOT_VERSION,
    FleetSnapshot,
    PlacementSpec,
    SvdFleet,
    assign,
    plan_devices,
    shard_loads,
    shard_of,
)
from repro_torch.serve import SvdService
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import largest_factorization, plan_mesh, plan_shard_count
from repro_torch.updates import RemoveRows, Sparse, Window

RAPI = ref("api")
RFLEET = ref("fleet")
RU = ref("updates")
RCKPT = ref("train.checkpoint")
RELASTIC = ref("train.elastic")

M, N, R = 8, 10, 3
STREAMS = 5
IDS = [f"s{i}" for i in range(STREAMS)]
POLICY = api.UpdatePolicy(method="direct")
CPU = torch.device("cpu")


def _states_np(seed=7):
    rng = np.random.default_rng(seed)
    return [(np.linalg.qr(rng.normal(size=(M, R)))[0],
             np.sort(np.abs(rng.normal(size=R)))[::-1].copy(),
             np.linalg.qr(rng.normal(size=(N, R)))[0]) for _ in range(STREAMS)]


def _traffic(count, seed=8):
    rng = np.random.default_rng(seed)
    return [(f"s{i % STREAMS}", rng.normal(size=M), rng.normal(size=N)) for i in range(count)]


def _single(**kw) -> SvdService:
    kw.setdefault("max_batch", 1 << 30)       # no autoflush: the settle path
    svc = SvdService(policy=POLICY, **kw)
    for sid, f in zip(IDS, _states_np()):
        svc.register(sid, api.SvdState.from_factors(*f, device="cpu"))
    return svc


def _fleet(shards, **kw) -> SvdFleet:
    kw.setdefault("continuous", False)
    kw.setdefault("max_batch", 1 << 30)
    fl = SvdFleet(shards, policy=POLICY, **kw)
    for sid, f in zip(IDS, _states_np()):
        fl.register(sid, api.SvdState.from_factors(*f, device="cpu"))
    return fl


def _ref_fleet(shards, **kw):
    kw.setdefault("continuous", False)
    kw.setdefault("max_batch", 1 << 30)
    fl = RFLEET.SvdFleet(shards, policy=RAPI.UpdatePolicy(method="direct"), **kw)
    for sid, f in zip(IDS, _states_np()):
        fl.register(sid, RAPI.SvdState.from_factors(*(jnp.asarray(x) for x in f)))
    return fl


def _feed(tgt, events, *, jax_side=False):
    cast = jnp.asarray if jax_side else (lambda x: x)
    return [tgt.enqueue(sid, cast(a), cast(b)) for sid, a, b in events]


def _exact(a, b):
    for f in ("u", "s", "v"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def _leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _restore(path, **kw):
    return SvdFleet.restore(path, device="cpu", **kw)


# -- placement ---------------------------------------------------------------------

ID_POOL = [f"user-{i}" for i in range(10_000)]


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_shard_of_matches_reference(shards):
    spec, rspec = PlacementSpec(shards), RFLEET.PlacementSpec(shards)
    assert [shard_of(spec, s) for s in ID_POOL] == [RFLEET.shard_of(rspec, s) for s in ID_POOL]
    assert shard_loads(spec, ID_POOL) == RFLEET.shard_loads(rspec, ID_POOL)


def test_salted_spec_loads_and_json_match_reference():
    spec, rspec = PlacementSpec(8, salt="tenant-a"), RFLEET.PlacementSpec(8, salt="tenant-a")
    assert assign(spec, ID_POOL) == RFLEET.assign(rspec, ID_POOL)
    assert assign(spec, ID_POOL) != assign(PlacementSpec(8), ID_POOL)
    assert spec.to_json() == rspec.to_json()
    assert PlacementSpec.from_json(rspec.to_json()) == spec
    assert spec.replaced(3) == PlacementSpec(3, salt="tenant-a")
    loads = shard_loads(spec, ID_POOL)
    assert max(loads) / (len(ID_POOL) / 8) < 1.2
    with pytest.raises(ValueError):
        PlacementSpec(0)


def test_plan_devices_round_robin_and_over_a_mesh():
    devs = [torch.device("cpu"), torch.device("meta")]
    assert plan_devices(5, devices=devs) == (devs[0], devs[1], devs[0], devs[1], devs[0])
    mesh = make_host_mesh(2, 2, device="cpu")
    assert plan_devices(3, mesh=mesh) == (CPU, CPU, CPU)
    with pytest.raises(ValueError, match="no devices"):
        plan_devices(2, devices=[])


def test_elastic_planners_match_reference():
    for n in (1, 6, 12, 16, 48, 7):
        assert largest_factorization(n) == RELASTIC.largest_factorization(n)
        assert largest_factorization(n, 4) == RELASTIC.largest_factorization(n, 4)
    assert plan_shard_count(devices=[CPU] * 3) == 3
    assert plan_shard_count(2, devices=[CPU] * 3) == 2
    assert plan_mesh(device="cpu").shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no live devices"):
            plan_shard_count()


# -- routing and the surface -------------------------------------------------------


def test_fleet_routes_streams_and_keeps_service_surface():
    fl = _fleet(3)
    assert fl.num_shards == 3
    for sid, f in zip(IDS, _states_np()):
        assert fl.shard_of(sid) == shard_of(fl.placement, sid)
        assert torch.equal(fl.state(sid).u, torch.as_tensor(f[0]))
    events = _traffic(11)
    toks = _feed(fl, events)
    assert fl.pending() == 11
    for (sh, _), (sid, _, _) in zip(toks, events):
        assert sh == fl.shard_of(sid)
    fl.evict("s0")
    with pytest.raises(KeyError):
        fl.state("s0")
    with pytest.raises(ValueError):
        SvdFleet(2, policy=POLICY, placement=PlacementSpec(4))


def test_shards_publish_labelled_series_and_the_fleet_rollup():
    obs.enable()
    try:
        fl = _fleet(2, continuous=True, max_batch=64)
        _feed(fl, _traffic(10))
        fl.drain()
        st = fl.stats()
        assert st.applied == 10
        reg = obs.registry()
        assert reg.gauge("fleet_applied").value == 10
        per = sum(reg.gauge("serve_applied", shard=str(i)).value for i in range(2))
        assert per == 10
    finally:
        obs.disable()


# -- the acceptance contract: query == single service, bitwise ----------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_query_bitwise_vs_single_service(shards):
    events = _traffic(17)
    svc = _single()
    _feed(svc, events)
    fl = _fleet(shards)
    _feed(fl, events)
    _exact(fl.query(IDS, rank=R), svc.merge_streams(IDS, rank=R))


def test_query_matches_reference_fleet():
    """The port's fleet query against the reference fleet's on the same f64
    inputs: within 1e-12 of sigma_max (the merged core runs the same
    rank-1 steps in another implementation)."""
    events = _traffic(17)
    fl, rfl = _fleet(2), _ref_fleet(2)
    _feed(fl, events)
    _feed(rfl, events, jax_side=True)
    got, want = fl.query(IDS, rank=R), rfl.query(IDS, rank=R)
    smax = float(np.asarray(want.s)[0])
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=0, atol=1e-12 * smax)
    recon = lambda st: np.asarray(st.u) * np.asarray(st.s) @ np.asarray(st.v).T  # noqa: E731
    np.testing.assert_allclose(recon(got), recon(want), rtol=0, atol=1e-12 * smax)


def test_query_respects_stream_order_not_shard_order():
    events = _traffic(13)
    perm = [IDS[i] for i in (3, 0, 4, 2, 1)]
    svc = _single()
    _feed(svc, events)
    fl = _fleet(3)
    _feed(fl, events)
    _exact(fl.query(perm, rank=R), svc.merge_streams(perm, rank=R))


def test_merge_streams_registers_target_on_its_hashed_shard():
    fl = _fleet(2)
    _feed(fl, _traffic(6))
    merged = fl.merge_streams(IDS[:3], target="merged", rank=R)
    _exact(fl.state("merged"), merged)
    assert "merged" in fl.shards[fl.shard_of("merged")].service._streams


# -- continuous batching -----------------------------------------------------------


def test_all_tokens_become_visible_after_drain():
    fl = _fleet(2, continuous=True, max_batch=64, max_depth=4)
    toks = _feed(fl, _traffic(20))
    fl.drain()
    assert set(fl.poll()) == set(toks)
    assert fl.poll() == []
    assert fl.pending() == 0


def test_continuous_drain_seals_deep_scan_rounds():
    fl = _fleet(1, continuous=True, max_batch=64, max_depth=8)
    _feed(fl, [("s0", a, b) for _, a, b in _traffic(8)])
    fl.drain()
    st = fl.stats()
    assert st.scan_rounds >= 1 and st.max_depth == 8 and st.applied == 8


def test_continuous_ordering_replay_bitwise():
    def run():
        fl = _fleet(2, continuous=True, max_batch=64, max_depth=4)
        for i, (sid, a, b) in enumerate(_traffic(18)):
            fl.enqueue(sid, a, b)
            if i % 5 == 4:
                fl.pump()
        fl.drain()
        return [fl.state(sid) for sid in IDS]

    for x, y in zip(run(), run()):
        _exact(x, y)


def test_continuous_ordering_pump_pattern_invariant():
    """Every pump pattern applies each stream's FIFO in order: all agree
    with the sequential settle (within 1e-9, the reference's bound; the
    windows cut different batch compositions)."""
    events = _traffic(18)
    single = _single()
    _feed(single, events)
    want = single.settle(IDS)
    for period in (1, 3, 7, None):
        fl = _fleet(2, continuous=True, max_batch=64, max_depth=4)
        for i, (sid, a, b) in enumerate(events):
            fl.enqueue(sid, a, b)
            if period and i % period == period - 1:
                fl.pump()
        fl.drain()
        for sid, w in zip(IDS, want):
            for f in ("u", "s", "v"):
                np.testing.assert_allclose(getattr(fl.state(sid), f).numpy(),
                                           getattr(w, f).numpy(), rtol=1e-9, atol=1e-9)


def test_fixed_mode_is_the_plain_service():
    events = _traffic(16)
    svc = _single(max_batch=4)
    _feed(svc, events)
    svc.drain()
    fl = _fleet(1, continuous=False, max_batch=4)
    _feed(fl, events)
    fl.drain()
    for sid in IDS:
        _exact(fl.state(sid), svc.state(sid))


def test_backpressure_bounds_pending():
    fl = _fleet(1, continuous=True, max_batch=64, max_depth=2, max_backlog=4, max_in_flight=1)
    peak = 0
    for sid, a, b in _traffic(16):
        fl.enqueue(sid, a, b)
        peak = max(peak, fl.pending())
    assert peak <= 4
    fl.drain()
    assert fl.pending() == 0
    assert fl.stats().backpressure_waits >= 1


def test_fleet_under_a_mesh_equals_the_plain_fleet():
    """A fleet whose policy spreads rounds over a four-entry mesh (B not a
    multiple of it: padding) gives the plain fleet's states, bitwise."""
    events = _traffic(23)
    runs = []
    for mesh in (None, make_host_mesh(4, device="cpu")):
        fl = SvdFleet(2, policy=POLICY.replace(mesh=mesh), continuous=True, max_batch=64,
                      max_depth=4, devices="auto" if mesh is not None else None)
        for sid, f in zip(IDS, _states_np()):
            fl.register(sid, api.SvdState.from_factors(*f, device="cpu"))
        _feed(fl, events)
        fl.drain()
        runs.append([fl.state(sid) for sid in IDS])
    for x, y in zip(*runs):
        _exact(x, y)


# -- FleetSnapshot v8 --------------------------------------------------------------


def test_snapshot_roundtrip_in_process(tmp_path):
    fl = _fleet(3)
    _feed(fl, _traffic(14))
    snap = fl.snapshot()
    assert snap.version == FLEET_SNAPSHOT_VERSION == 8
    assert snap.placement == fl.placement
    assert dict(snap.config)["continuous"] is False
    fl.save(tmp_path, step=14)
    step, loaded = FleetSnapshot.load(tmp_path)
    assert step == 14
    re = SvdFleet.from_snapshot(loaded, policy=POLICY, device="cpu")
    assert re.num_shards == 3 and re.pending() == 14
    svc = _single()
    _feed(svc, _traffic(14))
    _exact(re.query(IDS, rank=R), svc.merge_streams(IDS, rank=R))


def test_snapshot_refuses_newer_version_and_foreign_checkpoints(tmp_path):
    fl = _fleet(2)
    newer = dataclasses.replace(fl.snapshot(), version=FLEET_SNAPSHOT_VERSION + 1)
    newer.save(tmp_path / "newer", step=1)
    with pytest.raises(ValueError, match="newer"):
        FleetSnapshot.load(tmp_path / "newer")
    with pytest.raises(ValueError, match="newer"):
        RFLEET.FleetSnapshot.load(tmp_path / "newer")
    ckpt.save(tmp_path / "plain", 1, {"x": np.zeros(2)}, aux={"format": "other"})
    with pytest.raises(ValueError, match="not a FleetSnapshot"):
        FleetSnapshot.load(tmp_path / "plain")
    # a service snapshot is not a fleet snapshot either
    _single().save(tmp_path / "svc", step=1)
    with pytest.raises(ValueError, match="not a FleetSnapshot"):
        FleetSnapshot.load(tmp_path / "svc")


def test_elastic_regroup_is_bitwise(tmp_path):
    fl = _fleet(2)
    _feed(fl, _traffic(14))
    fl.save(tmp_path, step=14)
    svc = _single()
    _feed(svc, _traffic(14))
    want = svc.merge_streams(IDS, rank=R)
    for k in (1, 3, 4):
        step, re = _restore(tmp_path, num_shards=k, policy=POLICY)
        assert (step, re.num_shards, re.placement.num_shards, re.pending()) == (14, k, k, 14)
        for sid in IDS:
            assert sid in re.shards[re.shard_of(sid)].service._streams
        _exact(re.query(IDS, rank=R), want)


def test_regrouped_four_two_four_is_bitwise_and_matches_reference():
    """4 -> 2 -> 4 gives back the same leaves per stream; each regroup's
    leaves and aux spec equal the reference's regroup of the same snapshot."""
    fl, rfl = _fleet(4), _ref_fleet(4)
    events = _traffic(19)
    _feed(fl, events)
    _feed(rfl, events, jax_side=True)
    snap = fl.snapshot()
    rsnap = rfl.snapshot()
    _leaves_equal(snap.leaves(), [np.asarray(x) for x in jax.tree.leaves(rsnap)])
    two, rtwo = snap.regrouped(2), rsnap.regrouped(2)
    assert two.aux() == rtwo.aux()
    _leaves_equal(two.leaves(), [np.asarray(x) for x in jax.tree.leaves(rtwo)])
    back = two.regrouped(4)
    assert back.placement == snap.placement
    for s_back, s_orig in zip(back.shards, snap.shards):
        assert set(s_back.stream_ids) == set(s_orig.stream_ids)
        order = [s_back.stream_ids.index(sid) for sid in s_orig.stream_ids]
        for field in ("states", "pending_a", "pending_b"):
            _leaves_equal(_tree.tree_leaves([getattr(s_back, field)[i] for i in order]),
                          _tree.tree_leaves(list(getattr(s_orig, field))))


def test_regrouped_same_count_is_identity_and_auto_plans_devices(tmp_path):
    fl = _fleet(2)
    snap = fl.snapshot()
    assert snap.regrouped(2) is snap
    _feed(fl, _traffic(9))
    fl.save(tmp_path, step=9)
    _, re = _restore(tmp_path, num_shards="auto", policy=POLICY, devices=[CPU])
    assert re.num_shards == 1 and re.pending() == 9


def _deletion_traffic(tgt, *, jax_side=False):
    """Pairs, then a RemoveRows and a Window a stream, then a pair each at
    the shrunk geometry (the reference's ops on the jax side)."""
    rng = np.random.default_rng(21)
    post = [(sid, rng.normal(size=5), rng.normal(size=N)) for sid in IDS]
    _feed(tgt, _traffic(10), jax_side=jax_side)
    remove, window = (RU.RemoveRows, RU.Window) if jax_side else (RemoveRows, Window)
    for sid in IDS:
        tgt.enqueue_op(sid, remove((1, 6)))
        tgt.enqueue_op(sid, window(5, lam=0.9))
    _feed(tgt, post, jax_side=jax_side)


def test_elastic_regroup_with_pending_deletions(tmp_path):
    fl = _fleet(2)
    _deletion_traffic(fl)
    n_events = fl.pending()
    assert n_events == 10 + 3 * STREAMS
    fl.save(tmp_path, step=1)
    svc = _single()
    _deletion_traffic(svc)
    want = svc.settle(IDS)
    for k in (1, 3):
        _, re = _restore(tmp_path, num_shards=k, policy=POLICY)
        assert re.pending() == n_events
        for st, w in zip(re.settle(IDS), want):
            assert st.shape == (5, N)
            _exact(st, w)


def test_reference_fleet_snapshot_restores_in_port(tmp_path):
    """A FleetSnapshot the reference wrote, with pairs, a Sparse event and
    deletions pending, loads in the port with its leaves and aux bitwise;
    the restored port fleet settles as the reference does (1e-10)."""
    rfl = _ref_fleet(2)
    _deletion_traffic(rfl, jax_side=True)
    rng = np.random.default_rng(3)
    sp = (rng.integers(0, 5, 6).astype(np.int32), rng.integers(0, N, 6).astype(np.int32),
          rng.normal(size=6))
    rfl.enqueue_op("s1", RU.Sparse(*(jnp.asarray(x) for x in sp), rank=2))
    rfl.save(tmp_path, step=4)
    ref_leaves = RCKPT.restore(tmp_path, None)[1]
    _, snap = FleetSnapshot.load(tmp_path)
    _leaves_equal(snap.leaves(), ref_leaves)
    rsnap = rfl.snapshot()
    psnap = convert.fleet_snapshot_from_reference(
        [np.asarray(x) for x in jax.tree.leaves(rsnap)], rsnap.aux())
    assert psnap.aux() == rsnap.aux()
    _leaves_equal(convert.fleet_snapshot_to_reference(psnap)[0], ref_leaves)
    step, port = _restore(tmp_path)
    assert step == 4 and port.pending() == rfl.pending()
    # the downdates leave exactly repeated singular values, whose vectors'
    # signs neither route fixes: compare s and the reconstruction
    for got, want in zip(port.settle(IDS), rfl.settle(IDS)):
        np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got.materialize().numpy(),
                                   np.asarray(want.u) * np.asarray(want.s) @ np.asarray(want.v).T,
                                   rtol=0, atol=1e-10)


def test_port_fleet_snapshot_restores_in_reference(tmp_path):
    fl = _fleet(3)
    _deletion_traffic(fl)
    fl.enqueue_op("s2", Sparse(np.array([0, 1, 4], np.int32), np.array([2, 9, 0], np.int32),
                               np.array([1.5, -0.5, 2.0]), rank=2))
    fl.save(tmp_path, step=6)
    port_leaves = ckpt.restore(tmp_path, None)[1]
    step, back = RFLEET.SvdFleet.restore(tmp_path)
    assert step == 6 and back.num_shards == 3 and back.pending() == fl.pending()
    _leaves_equal([np.asarray(x) for x in jax.tree.leaves(back.snapshot())], port_leaves)
    leaves, aux = convert.fleet_snapshot_to_reference(fl.snapshot())
    rsnap = jax.tree.unflatten(jax.tree.structure(RFLEET.FleetSnapshot.skeleton(aux)), leaves)
    _leaves_equal([np.asarray(x) for x in jax.tree.leaves(rsnap)], port_leaves)
    # the restored reference fleet regroups as the port's does
    _, re = _restore(tmp_path, num_shards=2)
    _leaves_equal(re.snapshot().leaves(),
                  [np.asarray(x) for x in jax.tree.leaves(back.snapshot().regrouped(2))])
