#!/usr/bin/env python3
"""What the program's tracing costs a training step of a benchmark cell.

On a machine with an H100, from the root of a checkout:

    python3 tools/trace_cost.py [--workload granite34b.spectral-adam]
        [--seed N] [--blocks 4] [--steps 10] [--spans 20000]

Builds the cell's state from the seed as ``perfbench``'s driver does, warms
it by two steps, times ``--spans`` empty spans with tracing off, on (host
events and profiler ranges) and on with ``device=True`` (µs a span, host
clock), then runs ``--blocks`` rounds of the turns off, on, on, off
(ABBA) of ``--steps`` steps each: "off" with the program's tracing off,
"on" with ``obs.start_tracing(device=True)`` (host events, profiler ranges
and CUDA event pairs on every span).  Every step runs under the benchmark's
``StepTimers`` (CUDA events around the patched pieces, the yardstick of
``train.tracker_ms``), and each block is timed on the host clock to a
synchronize.  Prints one JSON object: per turn the mean ``trackers``,
``fwd_bwd`` and ``optimizer`` ms of a step and the host ms of a step, and
the median over the blocks of each block's on / off ratio.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="granite34b.spectral-adam")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 261)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--spans", type=int, default=20000)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import device as hdev
    from perfbench.harness import manifest
    from perfbench.inputs import granite as gin
    from repro_torch import obs
    from repro_torch.train import loop

    dev = torch.device("cuda", 0)
    cell = manifest.resolve(args.workload)
    drv = manifest.driver(cell.traffic["driver"])
    cfg, traffic = cell.config, cell.traffic
    api, opt = drv.program(cfg, traffic)
    params = gin.make_weights(cfg, args.seed, dev)
    holder = {"p": params, "s": drv.build_state(cfg, traffic, params, args.seed, dev), "i": 0}
    del params
    batches = gin.Batches(cfg, args.seed, dev)

    def steps(n: int) -> None:
        for _ in range(n):
            holder["p"], holder["s"], _, _ = loop.train_step(
                api, opt, holder["p"], holder["s"], batches.next(), holder["i"], spectral=True)
            holder["i"] += 1

    steps(2)
    torch.cuda.synchronize()
    span_us = {}
    for mode in ("off", "host", "device"):
        obs.clear_trace()
        if mode != "off":
            obs.start_tracing(device=mode == "device")
        t0 = time.perf_counter()
        for _ in range(args.spans):
            with obs.span("x"):
                pass
        span_us[mode] = (time.perf_counter() - t0) * 1e6 / args.spans
        obs.stop_tracing()
        obs.device_times()
    turns = {"off": [], "on": []}
    keys = ("trackers", "fwd_bwd", "optimizer", "host_ms")
    ratios = []
    for _ in range(args.blocks):
        block = {"off": [], "on": []}
        for turn in ("off", "on", "on", "off"):
            obs.clear_trace()
            if turn == "on":
                obs.start_tracing(device=True)
            t0 = time.perf_counter()
            with drv.StepTimers() as timers:
                steps(args.steps)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
            obs.stop_tracing()
            spans = len(obs.trace_events()) / args.steps
            obs.device_times()
            pieces = timers.split()
            block[turn].append({k: statistics.mean(p[k] for p in pieces) for k in keys[:3]}
                               | {"host_ms": host_ms, "spans_a_step": spans})
        for turn in turns:
            turns[turn] += block[turn]
        ratios.append({k: statistics.mean(b[k] for b in block["on"])
                       / statistics.mean(b[k] for b in block["off"]) for k in keys})
    obs.clear_trace()
    mean = {t: {k: statistics.mean(b[k] for b in bl) for k in bl[0]} for t, bl in turns.items()}
    ratio = {k: statistics.median(r[k] for r in ratios) for k in keys}
    out = {"card": hdev.card_name(), "power_limit_w": hdev.power_limit_w(),
           "workload": args.workload, "seed": args.seed, "steps_a_block": args.steps,
           "span_us": span_us, "blocks": turns, "mean": mean, "median_on_over_off": ratio}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
