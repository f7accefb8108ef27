"""``repro_torch.obs`` against the reference's ``repro.obs``: the metrics
registry, span tracing and the numerical-health probes.

The registry and the tracer are the port's own copies of framework-free
modules: the exporters must give the reference's exact text, and snapshot
rows must restore across the two packages.  The probes are PyTorch functions,
held to the reference's on the same numpy inputs (f64, 1e-12).  With
observability disabled an update gives the same bits and makes the same
calls into the engine and the kernels' wrappers as with it on (the port's
form of the reference's equal-jaxpr rule); the service's and the engine's and
planner's sites record nothing while it is off.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import api, obs
from repro_torch.core.engine import SvdEngine
from repro_torch.kernels import _build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.svd_service import SNAPSHOT_VERSION, ServiceSnapshot, SvdService
from repro_torch.updates import RankK
from repro_torch.updates.planner import lower, schedule_cache_info

ROBS = ref("obs")
RAPI = ref("api")

# the probes against the reference's on the same f64 inputs
PROBE_TOL = 1e-12


@pytest.fixture(autouse=True)
def _isolated_obs():
    """A fresh registry and disabled obs around every test, in both packages."""
    prev = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    rprev = ROBS.metrics.set_registry(ROBS.metrics.MetricsRegistry())
    for o in (obs, ROBS):
        o.disable()
        o.stop_tracing()
        o.clear_trace()
    yield
    for o in (obs, ROBS):
        o.stop_tracing()
        o.clear_trace()
        o.disable()
    obs_metrics.set_registry(prev)
    ROBS.metrics.set_registry(rprev)


def _dense(rng, m=12, n=9):
    return rng.standard_normal((m, n))


def _state(m=12, n=9, rank=None, rng=None):
    rng = rng if rng is not None else np.random.default_rng(0)
    return api.SvdState.from_dense(_dense(rng, m, n), rank=rank if rank is not None else min(m, n),
                                   device="cpu")


def _event(m=12, n=9, rng=None):
    rng = rng if rng is not None else np.random.default_rng(1)
    return rng.standard_normal(m), rng.standard_normal(n)


def _fill(reg):
    reg.counter("flushes", shard="0").inc(2)
    reg.gauge("depth").set(3)
    h = reg.histogram("lat_us", bounds=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)


# -- registry semantics (the reference's cases) ---------------------------------


def test_counter_gauge_histogram_basics():
    reg = obs.registry()
    c = reg.counter("events")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert reg.counter("events") is c
    g = reg.gauge("depth")
    g.set(3)
    g.max(7)
    g.max(2)
    assert g.value == 7.0
    h = reg.histogram("lat", bounds=(1.0, 10.0))
    for x in (0.5, 5.0, 50.0):
        h.observe(x)
    assert h.count == 3
    assert h.sum == pytest.approx(55.5)
    assert h.value["counts"] == [1, 1, 1]


def test_kind_conflict_raises():
    reg = obs.registry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered as counter"):
        reg.gauge("x")


def test_labels_make_independent_series_and_aggregate_sums():
    reg = obs.registry()
    reg.counter("applied", shard="0").inc(3)
    reg.counter("applied", shard="1").inc(4)
    assert reg.get("applied", shard="0").value == 3
    assert reg.get("applied") is None
    assert reg.aggregate("applied") == 7.0


# -- exporters: the reference's exact text ----------------------------------------


def test_prometheus_export_golden_and_equal_to_reference():
    _fill(obs.registry())
    _fill(ROBS.registry())
    golden = "\n".join([
        '# TYPE depth gauge',
        'depth 3',
        '# TYPE flushes_total counter',
        'flushes_total{shard="0"} 2',
        '# TYPE lat_us histogram',
        'lat_us_bucket{le="1"} 1',
        'lat_us_bucket{le="10"} 2',
        'lat_us_bucket{le="+Inf"} 2',
        'lat_us_sum 5.5',
        'lat_us_count 2',
    ]) + "\n"
    assert obs.registry().to_prometheus() == golden == ROBS.registry().to_prometheus()


def test_json_export_golden_and_equal_to_reference():
    for o in (obs, ROBS):
        o.registry().counter("flushes", shard="0").inc(2)
        o.registry().gauge("depth").set(3)
    rows = json.loads(obs.registry().to_json())
    assert rows == [
        {"name": "depth", "labels": {}, "kind": "gauge", "value": 3.0},
        {"name": "flushes", "labels": {"shard": "0"}, "kind": "counter", "value": 2},
    ]
    assert obs.registry().to_json() == ROBS.registry().to_json()


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_registry_snapshot_rows_restore_across_packages(direction):
    src, dst = (obs, ROBS) if direction == "port_to_reference" else (ROBS, obs)
    reg = src.registry()
    reg.counter("c", shard="2").inc(9)
    reg.gauge("g").set(1.5)
    h = reg.histogram("h", bounds=(1.0,))
    h.observe(0.5)
    h.observe(2.0)
    rows = reg.snapshot()
    hash(rows)                                  # rows ride snapshot metadata
    dst.registry().restore(json.loads(json.dumps(rows)))    # the aux round trip
    assert dst.registry().get("c", shard="2").value == 9
    assert dst.registry().get("g").value == 1.5
    assert dst.registry().get("h").value["counts"] == [1, 1]
    assert dst.registry().snapshot() == rows


# -- tracing ------------------------------------------------------------------------


def test_span_disabled_is_shared_noop():
    s1 = obs.span("a", x=1)
    s2 = obs.span("b")
    assert s1 is s2
    with s1 as sp:
        sp.set(y=2)
    assert obs.trace_events() == []


def test_chrome_trace_shape():
    obs.start_tracing()
    with obs.span("outer", depth=2):
        with obs.span("inner") as sp:
            sp.set(batch=4)
    obs.stop_tracing()
    doc = json.loads(obs.chrome_trace())
    assert doc["displayTimeUnit"] == "ms"
    by_name = {e["name"]: e for e in doc["traceEvents"]}
    assert set(by_name) == {"outer", "inner"}
    for e in by_name.values():
        assert e["ph"] == "X"
        assert e["dur"] >= 0.0
    assert by_name["inner"]["args"] == {"batch": 4}
    assert by_name["outer"]["ts"] <= by_name["inner"]["ts"]
    assert (by_name["inner"]["ts"] + by_name["inner"]["dur"]
            <= by_name["outer"]["ts"] + by_name["outer"]["dur"] + 1e-3)


def test_span_feeds_duration_histogram_when_enabled():
    obs.enable()
    obs.start_tracing()
    with obs.span("flush_round"):
        pass
    obs.stop_tracing()
    h = obs.registry().get("span_duration_us", span="flush_round")
    assert h is not None and h.count == 1


# -- spans the profiler sees, and the card's time on request ------------------------


def _tiny_spectral_step():
    """One spectral-Adam ``train_step`` on the port's granite smoke config
    (rank 4, the refresh due), as a call that returns its outputs' leaves."""
    from repro_torch import configs
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.spectral_adam import spectral_adam_init
    from repro_torch.train import loop

    cfg = configs.get_smoke("granite-34b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    state = spectral_adam_init(torch.Generator().manual_seed(1), params, rank=4, device="cpu")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10, spectral_rank=4,
                          basis_refresh_every=1)
    batch = batch_for_step(0, 0, batch=2, seq=16, vocab=cfg.vocab_size, device="cpu")
    return lambda: tree_leaves(loop.train_step(model, opt, params, state, batch, 0,
                                               spectral=True))


class _FakeEvent:
    """A CUDA event on the CPU: ``record`` reads a clock that ticks 1 ms a
    record; counts the events made."""

    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        type(self).clock += 1.0
        self.t = type(self).clock

    def elapsed_time(self, end):
        return end.t - self.t


def _no_event(*args, **kwargs):
    raise AssertionError("a CUDA event was made")


def test_spans_nest_in_the_profilers_trace(tmp_path):
    """The program's spans are profiler ranges: a train step's chain down to
    the deflation nests by time in the exported trace, with the aten ops
    inside."""
    step = _tiny_spectral_step()
    obs.start_tracing()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    obs.stop_tracing()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in evs
                if e["name"] == obs.trace.RANGE_PREFIX + name]

    chain = ["train_step", "optimizer", "trackers", "tracker_group", "core_update", "deflate"]
    for outer, inner in zip(chain, chain[1:]):
        assert ranges(inner), inner
        for i0, i1 in ranges(inner):
            assert any(o0 <= i0 and i1 <= o1 for o0, o1 in ranges(outer)), (outer, inner)
    d0, d1 = ranges("deflate")[0]
    assert any(e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
               and d0 <= e["ts"] and e["ts"] + e["dur"] <= d1 for e in evs)


def test_tracing_off_enters_no_range_and_makes_no_event(monkeypatch):
    counts = {"ranges": 0}
    real = torch.profiler.record_function

    class CountedRange(real):
        def __enter__(self):
            counts["ranges"] += 1
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", CountedRange)
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    step = _tiny_spectral_step()
    step()
    assert counts["ranges"] == 0 and obs.trace_events() == []
    obs.start_tracing()
    step()
    obs.stop_tracing()
    assert counts["ranges"] == len(obs.trace_events()) > 60


def test_device_tracing_without_a_card_is_host_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    obs.start_tracing(device=True)
    with obs.span("outer", m=3):
        with obs.span("inner"):
            torch.ones(3).sum()
    obs.stop_tracing()
    assert [e["name"] for e in obs.trace_events()] == ["inner", "outer"]
    assert obs.device_times() == []


def test_device_times_order_pool_and_graph_capture(monkeypatch):
    """Device spans (CUDA events faked on the CPU): read in enter order with
    their args, open spans left for a later read, one synchronize a read,
    nothing recorded while a graph is captured, events reused."""
    capturing = [False]
    syncs = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.__setitem__(0, syncs[0] + 1))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "clock", 0.0)

    obs.start_tracing(device=True)
    with obs.span("outer", m=4) as sp:
        with obs.span("inner"):
            pass
        with obs.span("open"):
            first = obs.device_times()
        sp.set(n=5)
    capturing[0] = True
    with obs.span("captured"):
        pass
    capturing[0] = False
    second = obs.device_times()
    assert [(t["name"], t["ms"], t["args"]) for t in first] == [("inner", 1.0, {})]
    assert [(t["name"], t["ms"], t["args"]) for t in second] == [
        ("outer", 5.0, {"m": 4, "n": 5}), ("open", 1.0, {})]
    # the first read's two events served the last two records
    assert syncs[0] == 2 and _FakeEvent.made == 4
    assert [e["name"] for e in obs.trace_events()] == ["inner", "open", "outer", "captured"]
    for _ in range(2):
        with obs.span("again"):
            pass
    obs.stop_tracing()
    assert [t["name"] for t in obs.device_times()] == ["again"] * 2
    assert _FakeEvent.made == 4 and obs.device_times() == [] and syncs[0] == 3


@pytest.mark.parametrize("case", ["train_step", "direct_update"])
def test_tracing_is_bitwise_invisible(case):
    if case == "train_step":
        run = _tiny_spectral_step()
    else:
        st = _state(rank=4)
        a, b = _event()
        pol = api.UpdatePolicy(method="direct")
        run = lambda: [getattr(api.update(st, a, b, pol), f) for f in "usv"]  # noqa: E731
    off = run()
    obs.start_tracing(device=True)
    on = run()
    obs.stop_tracing()
    assert {"core_update", "deflate", "givens"} <= {e["name"] for e in obs.trace_events()}
    assert len(off) == len(on)
    for x, y in zip(off, on):
        assert torch.equal(x, y)


def test_dropped_events_are_counted(monkeypatch):
    monkeypatch.setattr(obs.trace, "_MAX_EVENTS", 2)
    obs.start_tracing()
    for _ in range(5):
        with obs.span("x"):
            pass
    obs.stop_tracing()
    assert len(obs.trace_events()) == 2 and obs.dropped_events() == 3
    assert json.loads(obs.chrome_trace())["otherData"] == {"dropped_events": 3}
    obs.clear_trace()
    assert obs.dropped_events() == 0


# -- zero overhead when disabled ---------------------------------------------------------


def _spy_calls(monkeypatch):
    """Count the engine's and the kernels' wrappers' calls (on the CPU the
    wrappers run their plain versions; on a card each call is one launch)."""
    from repro_torch.kernels import ops as KOPS

    calls = {}
    for mod, name in ((SvdEngine, "_trunc"), (SvdEngine, "_full"),
                      (KOPS, "fused_update_truncated"), (KOPS, "fused_update"),
                      (KOPS, "cauchy_matmul_stable")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("method", ["direct", "fused", "pallas"])
def test_disabled_obs_is_bitwise_and_launch_invisible(method, monkeypatch):
    pol = api.UpdatePolicy(method=method, health_every=1)
    rng = np.random.default_rng(2)
    st = _state(rank=4, rng=rng)
    a, b = _event(rng=rng)
    calls = _spy_calls(monkeypatch)

    def run():
        calls.clear()
        before = dict(_build.LAUNCHES)
        svc = SvdService(max_batch=2, policy=pol)
        svc.register("s0", st)
        svc.register("s1", st)
        svc.enqueue("s0", a, b)
        svc.enqueue("s1", a, b)
        svc.drain()
        one = api.update(st, a, b, pol)
        launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
        return [svc.state("s0"), svc.state("s1"), one], dict(calls), launched

    off, calls_off, launched_off = run()
    obs.enable()
    obs.start_tracing()
    on, calls_on, launched_on = run()
    obs.stop_tracing()
    assert calls_on == calls_off and sum(calls_off.values()) > 0
    assert launched_on == launched_off
    for x, y in zip(off, on):
        for f in ("u", "s", "v"):
            assert torch.equal(getattr(x, f), getattr(y, f))


def test_disabled_sites_record_nothing():
    svc = SvdService(max_batch=2, policy=api.UpdatePolicy(method="direct", health_every=1))
    svc.register("s0", _state())
    svc.enqueue("s0", *_event())
    svc.drain()
    lower(RankK(np.zeros((12, 2)), np.zeros((9, 2))), _state())
    assert obs.registry().series() == []
    assert obs.trace_events() == []


# -- engine / planner counters mirror cache_info -----------------------------------


def test_engine_counters_match_cache_info():
    obs.enable()
    eng = SvdEngine()
    rng = np.random.default_rng(5)
    m, n = 6, 8
    u = torch.as_tensor(np.linalg.qr(rng.standard_normal((m, m)))[0])
    v = torch.as_tensor(np.linalg.qr(rng.standard_normal((n, n)))[0])
    s = torch.as_tensor(np.sort(np.abs(rng.standard_normal(m)))[::-1].copy())
    a, b = (torch.as_tensor(x) for x in _event(m, n, rng))
    stack = (u[None], s[None], v[None], a[None], b[None])
    eng.update_batch(*stack)
    eng.update_batch(*stack)
    info = eng.cache_info()
    reg = obs.registry()
    assert reg.get("engine_plan_cache_misses").value == info.misses == 1
    assert reg.get("engine_plan_cache_hits").value == info.hits == 1


def test_core_graph_counters_stay_zero_on_the_cpu():
    """On the CPU the truncated update's core never goes to a CUDA graph: its
    three counters stay at 0 and the update equals Brand's augmentation
    around the eager core, call after call."""
    from repro_torch.core.svd_update import TruncatedSvd, _svd_update_impl, _svd_update_truncated_impl

    obs.enable()
    rng = np.random.default_rng(8)
    m, n, r = 12, 9, 4
    u = torch.as_tensor(np.linalg.qr(rng.standard_normal((m, r)))[0])[None]
    v = torch.as_tensor(np.linalg.qr(rng.standard_normal((n, r)))[0])[None]
    s = torch.as_tensor(np.geomspace(10.0, 1.0, r))[None]
    a, b = (torch.as_tensor(x)[None] for x in _event(m, n, rng))
    p, q = ((basis.mT @ x[:, :, None])[:, :, 0] for basis, x in ((u, a), (v, b)))
    pp, qq = a - (u @ p[:, :, None])[:, :, 0], b - (v @ q[:, :, None])[:, :, 0]
    ra, rb = pp.norm(dim=1), qq.norm(dim=1)
    eye = torch.eye(r + 1, dtype=u.dtype).expand(1, r + 1, r + 1)
    core = _svd_update_impl(eye, torch.cat([s, torch.zeros(1, 1, dtype=s.dtype)], dim=1), eye,
                            torch.cat([p, ra[:, None]], dim=1), torch.cat([q, rb[:, None]], dim=1))
    want = TruncatedSvd(torch.cat([u, (pp / ra)[:, :, None]], dim=2) @ core.u[:, :, :r],
                        core.s[:, :r], torch.cat([v, (qq / rb)[:, :, None]], dim=2) @ core.v[:, :, :r])
    for _ in range(3):
        got = _svd_update_truncated_impl(TruncatedSvd(u, s, v), a, b, method="direct")
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    reg = obs.registry()
    for name in ("svd_core_graph_captures", "svd_core_graph_replays", "svd_core_graph_fallbacks"):
        assert getattr(reg.get(name), "value", 0) == 0, name


def test_planner_counters_match_schedule_cache_info():
    obs.enable()
    obs.start_tracing()
    rng = np.random.default_rng(3)
    st = _state(10, 8, 4, rng)
    op = RankK(rng.standard_normal((10, 2)), rng.standard_normal((8, 2)))
    before = schedule_cache_info()
    lower(op, st)
    lower(op, st)
    after = schedule_cache_info()
    obs.stop_tracing()
    reg = obs.registry()
    hits = getattr(reg.get("planner_schedule_cache_hits"), "value", 0)
    misses = getattr(reg.get("planner_schedule_cache_misses"), "value", 0)
    assert hits == after.hits - before.hits >= 1
    assert misses == after.misses - before.misses
    compiled = [e for e in obs.trace_events() if e["name"] == "schedule_compile"]
    assert len(compiled) == misses


# -- snapshot plumbing: registry rows ride service snapshots --------------------------


def test_service_snapshot_round_trips_obs_rows():
    obs.enable()
    pol = api.UpdatePolicy(method="direct", health_every=1)
    svc = SvdService(max_batch=2, policy=pol)
    svc.register("s0", _state())
    svc.enqueue("s0", *_event())
    svc.drain()
    snap = svc.snapshot()
    assert snap.version == SNAPSHOT_VERSION == 7
    assert snap.obs_metrics

    snap2 = ServiceSnapshot.skeleton(snap.aux())
    assert snap2.obs_metrics == snap.obs_metrics
    hash(snap2.obs_metrics)

    applied = obs.registry().get("serve_applied").value
    obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    svc2 = SvdService.from_snapshot(snap, device="cpu")
    assert obs.registry().get("serve_applied").value == applied
    assert svc2.stats.applied == svc.stats.applied


def test_old_snapshot_without_obs_rows_still_loads():
    svc = SvdService(max_batch=2, policy=api.UpdatePolicy(method="direct"))
    svc.register("s0", _state())
    svc.drain()
    aux = svc.snapshot().aux()
    del aux["obs_metrics"]
    assert ServiceSnapshot.skeleton(aux).obs_metrics == ()


# -- serve wiring: spans, stats gauges, health sampling ----------------------------------


def test_serve_flush_emits_spans_and_stats_gauges():
    obs.enable()
    obs.start_tracing()
    svc = SvdService(max_batch=2, policy=api.UpdatePolicy(method="direct", health_every=1))
    svc.register("s0", _state())
    svc.register("s1", _state())
    rng = np.random.default_rng(4)
    for _ in range(2):
        svc.enqueue("s0", *_event(rng=rng))
        svc.enqueue("s1", *_event(rng=rng))
    svc.drain()
    obs.stop_tracing()

    names = {e["name"] for e in obs.trace_events()}
    assert {"flush_round", "dispatch"} <= names
    reg = obs.registry()
    assert reg.get("serve_applied").value == svc.stats.applied == 4
    for probe in ("health_ortho_drift", "health_secular_residual",
                  "health_deflation_fraction", "health_bf16_headroom"):
        assert reg.get(probe) is not None, probe


def test_service_publishes_the_reference_series():
    """The same traffic through both services publishes the same series
    names and stats values."""
    for o in (obs, ROBS):
        o.enable()
    rng = np.random.default_rng(9)
    mats = [_dense(rng) for _ in range(2)]
    evs = [_event(rng=rng) for _ in range(4)]
    pol = dict(method="direct", health_every=2)
    svc = SvdService(max_batch=2, policy=api.UpdatePolicy(**pol))
    rsvc = ref("serve").SvdService(max_batch=2, policy=RAPI.UpdatePolicy(**pol))
    for i, mat in enumerate(mats):
        svc.register(f"s{i}", api.SvdState.from_dense(mat, rank=4, device="cpu"))
        rsvc.register(f"s{i}", RAPI.SvdState.from_dense(jnp.asarray(mat), rank=4))
    for j, (a, b) in enumerate(evs):
        svc.enqueue(f"s{j % 2}", a, b)
        rsvc.enqueue(f"s{j % 2}", jnp.asarray(a), jnp.asarray(b))
    svc.drain()
    rsvc.drain()
    # the engines' caches are process-wide, so which of hit and miss an
    # engine lookup counts depends on the tests before; their sum does not
    cache = ("engine_plan_cache_hits", "engine_plan_cache_misses")
    got = {(m.name, m.labels) for m in obs.registry().series() if m.name not in cache}
    want = {(m.name, m.labels) for m in ROBS.registry().series() if m.name not in cache}
    assert got == want
    lookups = [sum(getattr(o.registry().get(c), "value", 0) for c in cache) for o in (obs, ROBS)]
    assert lookups[0] == lookups[1] > 0
    for name, _ in got:
        if name.startswith("serve_"):
            assert obs.registry().get(name).value == ROBS.registry().get(name).value, name


# -- the probes: PyTorch against the reference's ---------------------------------------


def test_probe_update_matches_reference():
    rng = np.random.default_rng(13)
    mat = _dense(rng, 12, 9)
    a, b = _event(12, 9, rng)
    pol = dict(method="direct")
    st = api.SvdState.from_dense(mat, rank=4, device="cpu")
    out = api.update(st, a, b, api.UpdatePolicy(**pol))
    got = obs.probe_update(st.u, st.s, st.v, torch.as_tensor(a), torch.as_tensor(b),
                           out.u, out.s, out.v)
    want = ROBS.probe_update(*(jnp.asarray(x.numpy()) for x in (st.u, st.s, st.v)),
                             jnp.asarray(a), jnp.asarray(b),
                             *(jnp.asarray(x.numpy()) for x in (out.u, out.s, out.v)))
    np.testing.assert_allclose(np.array(got), np.array(want), atol=PROBE_TOL, rtol=0)
    assert float(obs.ortho_drift(out.u, out.v)) == pytest.approx(got.ortho_drift, abs=0)


def test_probe_update_on_exact_update_is_clean():
    pol = api.UpdatePolicy(method="direct")
    rng = np.random.default_rng(13)
    st = _state(12, 9, rng=rng)                # full-rank truncated: exact
    a, b = _event(12, 9, rng)
    out = api.update(st, a, b, pol)
    rep = obs.probe_update(st.u, st.s, st.v, torch.as_tensor(a), torch.as_tensor(b),
                           out.u, out.s, out.v)
    assert rep.ortho_drift < 1e-8
    assert rep.secular_residual < 1e-6
    assert 0.0 <= rep.deflation_fraction <= 1.0
    assert rep.bf16_headroom > 0.0


@pytest.mark.parametrize("scale", [1.0, 1.05])
def test_probe_state_matches_reference(scale):
    rng = np.random.default_rng(11)
    st = _state(10, 8, 4, rng)
    got = obs.probe_state(st.u * scale, st.s, st.v)
    want = ROBS.probe_state(jnp.asarray(st.u.numpy() * scale), jnp.asarray(st.s.numpy()),
                            jnp.asarray(st.v.numpy()))
    np.testing.assert_allclose(np.array(got), np.array(want), atol=PROBE_TOL, rtol=0)


def test_health_watchdog_warns_and_counts_on_drifted_state():
    obs.enable()
    rng = np.random.default_rng(11)
    st = _state(10, 8, 4, rng)
    mon = obs.HealthMonitor(every=1)
    with pytest.warns(obs.HealthWarning, match="ortho_drift"):
        mon.sample_state(st.u * 1.05, st.s, st.v)
    warned = obs.registry().get("health_warnings_total", probe="ortho_drift")
    assert warned is not None and warned.value == 1


def test_healthy_state_does_not_warn():
    obs.enable()
    st = _state(10, 8, 4)
    mon = obs.HealthMonitor(every=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error", obs.HealthWarning)
        mon.sample_state(st.u, st.s, st.v)
    assert obs.registry().get("health_ortho_drift").value < 1e-6


def test_health_every_cadence():
    obs.enable()
    mon = obs.HealthMonitor(every=3)
    assert [mon.due() for _ in range(7)] == [False, False, True, False, False, True, False]
    with pytest.raises(ValueError, match="health_every"):
        obs.HealthMonitor(every=0)


def test_policy_health_every_and_batch_axis_match_reference():
    pol = api.UpdatePolicy(health_every=3)
    rpol = RAPI.UpdatePolicy(health_every=3)
    assert (pol.health_every, pol.batch_axis) == (rpol.health_every, rpol.batch_axis)
    # neither knob keys the engine
    assert pol.engine_key(17) == api.UpdatePolicy().engine_key(17)
    assert pol.replace(batch_axis="x").engine_key(17) == pol.engine_key(17)
    for bad in (0, -2):
        with pytest.raises(ValueError, match="health_every"):
            api.UpdatePolicy(health_every=bad)
        with pytest.raises(ValueError, match="health_every"):
            RAPI.UpdatePolicy(health_every=bad)
