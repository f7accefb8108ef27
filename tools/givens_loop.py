#!/usr/bin/env python3
"""Time the phase chain's Givens step on the card under three rules.

On a machine with an H100, from the root of a checkout:

    python3 tools/givens_loop.py [--reps N]

``core/secular.py:apply_givens_columns`` applies a deflation's recorded
rotations in a loop of about eight launches a coordinate.  Up to
``GIVENS_LOOP_MAX`` coordinates the loop runs on a card without asking the
host whether any member rotates; above it the host asks once and skips the
loop when none does.  This script sets ``GIVENS_LOOP_MAX`` to

* ``0``: the host always asks (one wait for the device a call);
* the committed value;
* ``1 << 30``: the loop always runs, the host never asks;

and, in the turns A B C C B A, times with CUDA events (the median of
``--reps`` calls after one warm call) one ``api.update`` of ``chip_smoke.py``'s
drive (i) state, (1024, 1024) f64, on the ``direct`` and ``fmm`` routes, and
one flush round of ``chip_smoke.py``'s (s1) service (16 streams m512 n768
r16, f64, ``direct``), whose rounds it also counts the host's waits in
(``torch.cuda.set_sync_debug_mode``).  It prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch import api, serve  # noqa: E402
from repro_torch.core import secular  # noqa: E402


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _waits(fn) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    committed = secular.GIVENS_LOOP_MAX
    rules = {"host asks": 0, f"committed ({committed})": committed, "loop always": 1 << 30}

    a_mat, a, b = CS.fmm_inputs()["i"]
    state = api.SvdState.from_dense(a_mat, device=dev)
    s1 = CS.service_inputs()["s1"]

    def route(method):
        return lambda: api.update(state, a, b, api.UpdatePolicy(method=method))

    def service_round():
        svc = CS.serve_streams(api, serve, s1, method="direct", dtype=torch.float64, mif=2,
                               device=dev)
        CS.serve_rounds(svc, s1["rounds"][:1])
        svc.drain()
        return svc

    out = {name: {"direct (1024,1024) f64 ms": [], "fmm (1024,1024) f64 ms": [],
                  "service (s1) direct f64 round ms": [], "service (s1) direct f64 waits a round": []}
           for name in rules}
    order = list(rules) + list(reversed(rules))
    for name in order:
        secular.GIVENS_LOOP_MAX = rules[name]
        row = out[name]
        row["direct (1024,1024) f64 ms"].append(_events_ms(route("direct"), args.reps))
        row["fmm (1024,1024) f64 ms"].append(_events_ms(route("fmm"), args.reps))
        svc = service_round()
        rnd = s1["rounds"][1:2]

        def one_round(svc_=svc, rnd_=rnd):
            CS.serve_rounds(svc_, rnd_)
            svc_.drain()

        row["service (s1) direct f64 round ms"].append(_events_ms(one_round, args.reps))
        row["service (s1) direct f64 waits a round"].append(
            _waits(lambda s_=svc, r_=rnd: CS.serve_rounds(s_, r_)))
        svc.drain()
        print(f"{name}: " + json.dumps({k: v[-1] for k, v in row.items()}), flush=True)
    secular.GIVENS_LOOP_MAX = committed
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "turns": order, "rules": out}))


if __name__ == "__main__":
    main()
