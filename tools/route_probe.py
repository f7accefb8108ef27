#!/usr/bin/env python3
"""How a benchmark cell's MoE layers route its seeded traffic.

On a machine with an H100, from the root of a checkout:

    python3 tools/route_probe.py [--workload deepseek-v2-lite.spectral-adam]
        [--seeds 1,2]

For each seed, builds the cell's weights and its first batch as
``perfbench``'s driver does and runs the port's training loss once, without
gradients, with ``obs`` enabled.  Prints one JSON object a seed: the loss
and, for each MoE layer in depth order, the share of tokens whose top-1
expert is the most common one (``top1``), the largest share of all choices
on one expert (``max_expert``; 1/E is even), the choices routed to the held
experts (``routed_held``) and the share of those dropped over capacity
(``dropped``), with the totals over the layers.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def probe(workload: str, seed: int, device) -> dict:
    import torch

    from perfbench.harness import manifest
    from repro_torch import obs
    from repro_torch.models import moe

    cell = manifest.resolve(workload)
    drv = manifest.driver("train_model")
    inputs, _ = drv.modules(cell.config)
    api, _ = drv.program(cell.config, cell.traffic)
    layers: list = []
    route, count = moe._route, moe._count

    def traced_route(xg, router, m):
        probs, gates, idx = route(xg, router, m)
        top1 = torch.bincount(idx[..., 0].reshape(-1), minlength=m.n_routed)
        every = torch.bincount(idx.reshape(-1), minlength=m.n_routed)
        layers.append({"top1": top1.max() / top1.sum(), "max_expert": every.max() / every.sum()})
        return probs, gates, idx

    def traced_count(in_held, keep):
        layers[-1].update(routed_held=in_held.sum(), dropped_n=(in_held & ~keep).sum())

    moe._route, moe._count = traced_route, traced_count
    was = obs.enabled()
    obs.enable()
    try:
        params = inputs.make_weights(cell.config, seed, device)
        batch = inputs.Batches(cell.config, seed, device).next()
        with torch.no_grad():
            loss = float(api.train_loss(params, batch))
    finally:
        moe._route, moe._count = route, count
        if not was:
            obs.disable()
    rows = [{"top1": round(float(r["top1"]), 4), "max_expert": round(float(r["max_expert"]), 4),
             "routed_held": int(r["routed_held"]),
             "dropped": round(int(r["dropped_n"]) / max(int(r["routed_held"]), 1), 4)}
            for r in layers]
    held = sum(r["routed_held"] for r in rows)
    dropped = sum(int(r["dropped_n"]) for r in layers)
    return {"workload": workload, "seed": seed, "loss": loss, "layers": rows,
            "routed_held": held, "dropped": dropped / max(held, 1)}


def main(argv=None) -> list:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="deepseek-v2-lite.spectral-adam")
    ap.add_argument("--seeds", default="1,2")
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = ap.parse_args(argv)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out.append(probe(args.workload, seed, torch.device(args.device)))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
