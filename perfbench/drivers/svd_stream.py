"""Driver of an SVD-update service cell: a closed loop of clients on
``repro_torch.fleet.frontend.ContinuousBatcher`` over one ``SvdService``.

Every stream keeps ``outstanding`` rank-1 events in the service: the client
admits one (``admit``), and when ``poll`` shows one of its events visible it
admits its next.  The event loop ticks ``pump`` (which seals rounds while the
card has room: every stream with pending events, up to ``max_depth`` pairs
each) and ``poll``.  Events are pairs of host-side arrays from a seeded pool
(``perfbench.inputs.svd_stream``), as a client's events arrive.

Set-up registers every stream's seeded state on the card, warms the route at
the cell's batch (``api.warmup``: the kernels built and loaded) and runs
``warm_rounds`` rounds of the same traffic.  The window opens when a round
retires and closes at the first retirement ``--seconds`` or more later, so
it holds whole rounds (a round makes all of its events visible at once, and
a window cut inside one would count a part of a round's time and none of
its events): ``svd_events_per_s`` counts the events that became visible in
it over its length, ``svd_visible_p95_ms`` is the 95th percentile over the
events admitted in it of the time from ``admit`` to ``poll`` returning them.
After the window no event is admitted, and the loop runs on until every
admitted event is visible (at most ``drain_timeout_s``): a late event's wait
counts in its time; one that never comes fails the run.

Once everything is visible and the peak memory read, the checked streams'
states are copied and the service freed, and the plain reference
(``perfbench.reference.svd_stream``) replays each checked stream's events
from its seeded start.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.harness.device import peak_bytes, sync
from perfbench.harness.host import collector_held
from perfbench.harness.trace import profile_stretch, span
from perfbench.inputs import svd_stream as sin
from perfbench.reference import svd_stream as ref


class Clients:
    """The closed loop: per-stream event counters, and per token its stream,
    admit time and visible time (NaN until visible)."""

    def __init__(self, fe, cfg: dict, traffic: dict, pool_a, pool_b, timed: bool):
        self.fe, self.cfg, self.traffic = fe, cfg, traffic
        self.pool_a, self.pool_b = pool_a, pool_b
        self.offsets = sin.offsets(cfg, traffic)
        self.ids = [f"s{i:05d}" for i in range(cfg["streams"])]
        self.count = [0] * cfg["streams"]
        self.stream_of: list[int] = []
        self.admit_t: list[float] = []
        self.visible_t: list[float] = []
        self.admitting = True
        self.timed = timed
        self.admit_s = 0.0          # host seconds inside admit (timed only)
        self.admits = 0
        self.pump_s: list[float] = []   # host seconds of each pump that sealed rounds
        self.pump_rounds: list[int] = []
        self.bad_tokens = 0         # tokens made visible twice or never admitted
        self.visible = 0
        self.last_visible = float("nan")   # host time of the last tick that made events visible

    def admit(self, i: int) -> None:
        j = (int(self.offsets[i]) + self.count[i]) % self.traffic["pool"]
        t = time.perf_counter()
        tok = self.fe.admit(self.ids[i], self.pool_a[j], self.pool_b[j])
        if self.timed:
            self.admit_s += time.perf_counter() - t
            self.admits += 1
        if tok != len(self.admit_t):
            raise RuntimeError(f"the service returned token {tok} for the "
                               f"{len(self.admit_t)}-th admitted event")
        self.count[i] += 1
        self.stream_of.append(i)
        self.admit_t.append(t)
        self.visible_t.append(float("nan"))

    def start(self) -> None:
        with span("client"):
            for _ in range(self.traffic["outstanding"]):
                for i in range(len(self.ids)):
                    self.admit(i)

    def tick(self) -> int:
        """One turn of the event loop; returns the events that became visible."""
        svc = self.fe.service
        with span("pump"):
            if self.timed:
                rounds, t = svc.stats.flushes, time.perf_counter()
                if self.fe.pump():
                    self.pump_s.append(time.perf_counter() - t)
                    self.pump_rounds.append(svc.stats.flushes - rounds)
            else:
                self.fe.pump()
        with span("poll"):
            vis = self.fe.poll()
        now = time.perf_counter()
        if vis:
            self.last_visible = now
        with span("client"):
            for tok in vis:
                if tok >= len(self.visible_t) or self.visible_t[tok] == self.visible_t[tok]:
                    self.bad_tokens += 1
                    continue
                self.visible_t[tok] = now
                self.visible += 1
                if self.admitting:
                    self.admit(self.stream_of[tok])
        return len(vis)

    def pending(self) -> int:
        return len(self.admit_t) - self.visible


def run(ctx) -> dict:
    from repro_torch.api import SvdState, UpdatePolicy
    from repro_torch.api import warmup as api_warmup
    from repro_torch.api.update import engine_from_key
    from repro_torch.fleet.frontend import ContinuousBatcher
    from repro_torch.serve.svd_service import SvdService

    cfg, traffic, dev, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    m, n, r, S = cfg["m"], cfg["n"], cfg["rank"], cfg["streams"]
    dt = sin.dtype_of(cfg)
    policy = UpdatePolicy(method=cfg["method"])
    svc = SvdService(max_batch=cfg["max_batch"], policy=policy,
                     max_in_flight=cfg["max_in_flight"])
    fe = ContinuousBatcher(svc, max_depth=cfg["max_depth"], device=dev)
    u0, s0, v0 = sin.make_states(cfg, traffic, seed, dev)
    for i in range(S):
        svc.register(f"s{i:05d}", SvdState(u=u0[i], s=s0[i], v=v0[i]))
    del u0, s0, v0
    pool_a, pool_b = sin.make_pool(cfg, traffic, seed, dev)
    api_warmup(policy, m=m, n=n, batch=cfg["max_batch"], rank=r, dtype=dt, device=dev)

    clients = Clients(fe, cfg, traffic, pool_a, pool_b, timed=False)
    clients.start()
    while svc.stats.flushes < traffic["warm_rounds"]:
        clients.tick()
    engine = engine_from_key(policy, r + 1)
    misses0 = engine.cache_info().misses

    # the window opens and closes at a round's retirement, so it holds whole
    # rounds: every event visible in it over all of its time
    clients.timed = bool(ctx.trace)
    with collector_held():
        while True:
            first_token = len(clients.admit_t)   # the window's admits follow its opening
            if clients.tick():
                break
        t0 = clients.last_visible
        ctx.window_start(t0)
        while not (clients.tick() and clients.last_visible - t0 >= ctx.seconds):
            pass
        t1 = clients.last_visible
    misses = engine.cache_info().misses - misses0
    clients.timed = False
    window = t1 - t0

    trace = None
    if ctx.trace:
        deadline = traffic["trace_seconds"]

        def stretch():
            ts = time.perf_counter()
            while time.perf_counter() - ts < deadline:
                clients.tick()

        trace = profile_stretch(stretch, ctx.trace_path)

    clients.admitting = False
    t_close = time.perf_counter()
    while clients.pending() and time.perf_counter() - t_close < traffic["drain_timeout_s"]:
        clients.tick()
    sync(dev)
    peak = peak_bytes(dev)

    admit_t = np.asarray(clients.admit_t)
    vis_t = np.asarray(clients.visible_t)
    visible_in_window = int(np.count_nonzero((vis_t > t0) & (vis_t <= t1)))
    lat = (vis_t[first_token:len(admit_t)] - admit_t[first_token:])
    in_window = admit_t[first_token:] <= t1
    lat = lat[in_window]
    missing = int(np.count_nonzero(np.isnan(vis_t)))
    lat_done = lat[~np.isnan(lat)]
    p95 = float(np.percentile(lat_done, 95)) * 1e3 if lat_done.size else float("nan")
    if missing:
        p95 = float("inf")
    e2e = {"svd_events_per_s": visible_in_window / window, "svd_visible_p95_ms": p95}
    ctx.log(f"window: {visible_in_window} events visible in {window:.3f} s, {lat.size} admitted, "
            f"p50 {np.percentile(lat_done, 50) * 1e3 if lat_done.size else float('nan'):.1f} ms, "
            f"p95 {p95:.1f} ms; rounds {svc.stats.flushes}, largest batch {svc.stats.max_batch}, "
            f"deepest {svc.stats.max_depth}; {missing} never visible")

    rec = {"window_s": window, "events_per_s": e2e["svd_events_per_s"],
           "shape": {"m": m, "n": n, "r": r, "itemsize": torch.finfo(dt).bits // 8},
           "plan_cache_misses": misses, "kernel_b_batch": svc.stats.max_batch}
    if clients.admits:
        rec["admit_us"] = clients.admit_s / clients.admits * 1e6
    if clients.pump_rounds:
        rec["round_host_ms"] = sum(clients.pump_s) / sum(clients.pump_rounds) * 1e3

    checked = sin.sample_streams(cfg, traffic, seed)
    got = [svc.state(f"s{i:05d}") for i in checked]
    got = tuple(torch.stack([getattr(st, k) for st in got]).clone() for k in ("u", "s", "v"))
    counts = [clients.count[i] for i in checked]
    attempted, bad = len(admit_t), clients.bad_tokens
    del fe, svc, clients
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    u0, s0, v0 = sin.make_states(cfg, traffic, seed, dev)
    sel = torch.tensor(checked, device=dev)
    pa, pb = (torch.from_numpy(x).to(dev) for x in (pool_a, pool_b))
    want = ref.replay(u0[sel], s0[sel], v0[sel], pa, pb,
                      [sin.event_indices(cfg, traffic, i, c) for i, c in zip(checked, counts)])
    nums = ref.gaps(got, want)
    nums["never_visible"] = float(missing)
    nums["bad_tokens"] = float(bad)
    return {"e2e": e2e, "attempted": attempted, "failed": missing, "numbers": nums,
            "memory_peak_bytes": peak, "rec": rec, "trace": trace}
