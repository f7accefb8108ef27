"""Streaming SVD maintenance with the PyTorch/CUDA port: the paper's
motivating big-data scenario.

The port's counterpart of ``examples/streaming_svd.py``, at its sizes and
seeds.  A rank-r sketch of a user x item interaction matrix is kept under a
stream of rank-1 observations; each event is one ``api.update`` on a
truncated ``SvdState`` (Brand augmentation around the paper's
diagonal-plus-rank-1 core).  Geometry picks the route: at (600, 400, r 12)
``method="auto"`` takes the fused route, kernel B
(``csrc/fused_update.cuh``) on the card.  The dominant singular values are
compared with a fresh SVD of the accumulated matrix (truncation discards
rank-(r+1) mass, so exact equality is impossible for any streaming method).

Part 2 runs the serving shape through ``serve.SvdService``: micro-batched
flushes across several streams, a snapshot to disk mid-stream, and a
restored service that finishes the run with bitwise the same factors as the
one that never stopped.  The service resolves its engine without geometry,
so its flushes run ``direct`` (the phase chain, no kernel).  Part 3 is
structured perturbations through ``api.apply`` (decay, rank-k, appended
rows; auto takes kernel B for the rank-1 steps), part 4 a user deletion and
a retention window through the service, part 5 the same serving shape with
the ``repro_torch.obs`` telemetry on.

Run on the card:          python3 examples/streaming_svd_torch.py
Run on the CPU (plain):   python3 examples/streaming_svd_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api  # noqa: E402

M_USERS, N_ITEMS, RANK, EVENTS = 600, 400, 12, 200


def _factors(rng, m, n, r, device):
    return api.SvdState.from_factors(np.linalg.qr(rng.normal(size=(m, r)))[0], np.zeros((r,)),
                                     np.linalg.qr(rng.normal(size=(n, r)))[0], device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def stream_demo(device, events: int = EVENTS) -> dict:
    """Part 1: ``events`` rank-1 updates of a rank-12 sketch at (600, 400)."""
    rng = np.random.default_rng(0)

    # ground truth low-rank preference structure + noise stream
    u_true = rng.normal(size=(M_USERS, 4))
    v_true = rng.normal(size=(N_ITEMS, 4))

    dense = np.zeros((M_USERS, N_ITEMS))
    t = _factors(rng, M_USERS, N_ITEMS, RANK, device)

    policy = api.UpdatePolicy()            # auto: fused_supported(600, 400, 12), kernel B
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(events):
        # one "interaction batch": a user factor bumps an item direction
        a = u_true @ rng.normal(size=4) + 0.1 * rng.normal(size=M_USERS)
        b = v_true @ rng.normal(size=4) + 0.1 * rng.normal(size=N_ITEMS)
        dense += np.outer(a, b)
        t = api.update(t, a, b, policy)
    _sync(device)
    dt = time.perf_counter() - t0

    sv_stream = t.s.cpu().numpy()
    sv_true = np.linalg.svd(dense, compute_uv=False)[:RANK]
    rel = np.abs(sv_stream - sv_true) / sv_true[0]
    print(f"{events} rank-1 events in {dt:.2f}s "
          f"({dt / events * 1e3:.2f} ms/event, plan-cached engine, {t.device})")
    print("top-5 singular values (streamed) :", np.round(sv_stream[:5], 6))
    print("top-5 singular values (recompute):", np.round(sv_true[:5], 6))
    print(f"max relative deviation over rank-{RANK}: {rel.max():.2e}")
    assert rel[:3].max() < 1e-6  # dominant structure tracked
    return {"events": events, "seconds": dt, "max_rel_dev": float(rel.max()),
            "dominant_rel_dev": float(rel[:3].max()), "s": sv_stream}


def service_demo(device) -> dict:
    """Part 2: checkpointable streaming through ``serve.SvdService``."""
    from repro_torch.serve import SvdService

    rng = np.random.default_rng(1)
    m, n, r, streams, events = 48, 32, 4, 3, 18

    sketches = [_factors(rng, m, n, r, device) for _ in range(streams)]
    traffic = [(f"tenant-{i % streams}", rng.normal(size=m), rng.normal(size=n))
               for i in range(events)]

    def run(svc, evts):
        for sid, a, b in evts:
            svc.enqueue(sid, a, b)
        svc.drain()                      # barrier: all flushes retired

    # uninterrupted reference run
    ref = SvdService(max_batch=streams, max_in_flight=2)
    for i, sk in enumerate(sketches):
        ref.register(f"tenant-{i}", sk)
    run(ref, traffic)

    # the same run, killed in the middle: snapshot -> fresh service -> resume
    svc = SvdService(max_batch=streams, max_in_flight=2)
    for i, sk in enumerate(sketches):
        svc.register(f"tenant-{i}", sk)
    split = events // 2
    run(svc, traffic[:split])
    with tempfile.TemporaryDirectory() as ckpt_dir:
        svc.save(ckpt_dir, step=split)
        _, resumed = SvdService.restore(ckpt_dir, device=device)
    run(resumed, traffic[split:])

    s = []
    for i in range(streams):
        a = ref.state(f"tenant-{i}").s.cpu().numpy()
        b = resumed.state(f"tenant-{i}").s.cpu().numpy()
        np.testing.assert_array_equal(a, b)   # bitwise restore-exactness
        s.append(b)
    print(f"service: {events} events over {streams} streams, "
          f"{ref.stats.rounds} batched flush rounds, "
          f"snapshot+resume bitwise-identical")
    return {"rounds": ref.stats.rounds, "bitwise": True, "s": np.stack(s)}


def structured_demo(device) -> dict:
    """Part 3: a mini-batch rank-k absorb, a forgetting factor and a growing
    matrix through ``api.apply``, one planned schedule, checked against the
    dense reference."""
    from repro_torch.updates import AppendRows, Compose, Decay, RankK

    rng = np.random.default_rng(2)
    m, n, r, k = 24, 32, 6, 3
    base = rng.normal(size=(m, 2)) @ rng.normal(size=(2, n))   # rank-2 data
    state = api.SvdState.from_dense(base, rank=r, device=device)

    op = Compose((
        Decay(0.95),                                           # forget a little
        RankK(rng.normal(size=(m, k)) / 10,
              rng.normal(size=(n, k)) / 10),                   # minibatch sketch
        AppendRows(rng.normal(size=(2, 2)) / 10
                   @ rng.normal(size=(2, n))),                 # two new users
    ))
    state = api.apply(state, op)                               # auto: kernel B on the card

    dense = np.asarray(op.apply_dense(base))
    u, s, vt = np.linalg.svd(dense, full_matrices=False)
    ref = (u[:, :r] * s[:r]) @ vt[:r]
    err = np.abs(state.materialize().cpu().numpy() - ref).max()
    print(f"structured: decay+rank-{k}+append -> shape {state.shape}, "
          f"parity vs dense SVD {err:.2e}")
    assert state.shape == (m + 2, n)
    assert err < 1e-8
    return {"parity": float(err), "shape": state.shape, "s": state.s.cpu().numpy()}


def deletion_demo(device) -> dict:
    """Part 4: downdates through the service tier, a GDPR-style user deletion
    and a sliding retention window enqueued as ops: the sketch never rebuilds
    from dense, yet matches the SVD of the matrix with those rows gone."""
    from repro_torch.serve import SvdService
    from repro_torch.updates import RemoveRows, Window

    rng = np.random.default_rng(3)
    m, n, r, events = 40, 32, 5, 12
    dense = rng.normal(size=(m, 2)) @ rng.normal(size=(2, n))   # rank-2 data

    svc = SvdService(max_batch=4)
    svc.register("tenant-0", api.SvdState.from_dense(dense, rank=r, device=device))
    for _ in range(events):
        a = dense @ rng.normal(size=n)        # in-span traffic: rank stays 2
        b = dense.T @ rng.normal(size=m)
        svc.enqueue("tenant-0", a * 0.02, b * 0.02)
        dense = dense + 0.02 * 0.02 * np.outer(a, b)

    erased = (3, 17)                          # two users invoke erasure
    svc.enqueue_op("tenant-0", RemoveRows(erased))
    dense = np.delete(dense, erased, axis=0)

    keep = 30                                 # retention: newest 30 rows only
    svc.enqueue_op("tenant-0", Window(keep, lam=0.97))
    dense = 0.97 * dense[-keep:]

    svc.drain()
    state = svc.state("tenant-0")
    u, s, vt = np.linalg.svd(dense, full_matrices=False)
    ref = (u[:, :r] * s[:r]) @ vt[:r]
    err = np.abs(state.materialize().cpu().numpy() - ref).max()
    print(f"deletion: {events} events + erase {erased} + window {keep} "
          f"-> shape {state.shape}, parity vs dense SVD of deleted matrix "
          f"{err:.2e}")
    assert state.shape == (keep, n)
    assert err < 1e-8
    return {"parity": float(err), "shape": state.shape, "s": state.s.cpu().numpy()}


def obs_demo(device) -> dict:
    """Part 5: the same streaming workload with ``repro_torch.obs`` metrics,
    span tracing and numerical-health monitors on, ending with the
    end-of-run metrics summary an operator would scrape."""
    from repro_torch import obs
    from repro_torch.serve import SvdService

    rng = np.random.default_rng(4)
    m, n, r, streams, events = 48, 32, 4, 3, 18

    obs.enable()
    obs.start_tracing()
    try:
        svc = SvdService(
            max_batch=streams,
            policy=api.UpdatePolicy(health_every=2),   # probe every 2nd flush
        )
        for i in range(streams):
            svc.register(f"tenant-{i}", _factors(rng, m, n, r, device))
        for i in range(events):
            svc.enqueue(f"tenant-{i % streams}", rng.normal(size=m), rng.normal(size=n))
        svc.drain()
        obs.stop_tracing()

        # the trace is a valid Chrome trace_event document with flush spans
        doc = json.loads(obs.chrome_trace())
        spans = sorted({e["name"] for e in doc["traceEvents"]})
        assert "flush_round" in spans and "dispatch" in spans

        # end-of-run metrics summary: throughput counters + health gauges
        reg = obs.registry()
        drift = reg.get("health_ortho_drift").value
        assert reg.get("serve_applied").value == events
        assert drift < 1e-6                       # factors stayed orthonormal
        assert "# TYPE serve_applied gauge" in reg.to_prometheus()
        print(f"obs: {len(doc['traceEvents'])} spans {spans}, "
              f"applied={reg.get('serve_applied').value:.0f} "
              f"flush_rounds={reg.get('serve_rounds').value:.0f} "
              f"ortho_drift={drift:.1e}")
        return {"spans": spans, "n_events": len(doc["traceEvents"]),
                "applied": reg.get("serve_applied").value,
                "rounds": reg.get("serve_rounds").value, "ortho_drift": float(drift)}
    finally:
        obs.stop_tracing()
        obs.disable()
        obs.clear_trace()


def main(argv=None) -> dict:
    """Run all five parts; returns each part's figures."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--events", type=int, default=EVENTS, help="part 1's rank-1 events")
    args = ap.parse_args(argv)
    out = {"stream": stream_demo(args.device, args.events),
           "service": service_demo(args.device),
           "structured": structured_demo(args.device),
           "deletion": deletion_demo(args.device),
           "obs": obs_demo(args.device)}
    print("OK")
    return out


if __name__ == "__main__":
    main()
