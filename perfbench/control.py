"""Readings the limits of ``correct`` are set from (not run by the benchmark's
own runs): the program's numbers on many seeds, the control's, and planted
faults', at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--program] [--control] [--faults]

Training cells (driver ``train_step``): per seed, ``--program`` drives the
program's state through the compared steps (the run's own set-up, no window)
and compares it with the reference; ``--control`` puts the reference computed
with float8 products (the precision below the configuration's bfloat16) in
the program's place; ``--faults`` puts there the reference with half of each
batch's tokens left out of the loss (the mean over the rest), and reads what
a state left unchanged gives (1 on ``seen_grad`` and ``change`` by their
definition; on the trackers the gaps of the starting ones).

Service cells (driver ``svd_stream``): per seed, ``--control`` replays the
checked streams' events in float32 (the precision below the configuration's
float64) in the program's place, ``--events`` events a stream, and compares
with the float64 replay.  The program's readings come from the benchmark's
own runs, which print them.

Every reading is printed as one JSON line.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from perfbench.harness import manifest  # noqa: E402


def _granite(cell, seeds, args, dev):
    import torch

    from perfbench.inputs import granite as gin
    from perfbench.reference import granite as ref

    drv = manifest.driver("train_step")
    cfg, traffic = cell.config, cell.traffic
    api, opt = drv.program(cfg, traffic)
    for seed in seeds:
        t0 = time.perf_counter()
        params, state, _, prog = drv.program_readings(cfg, traffic, seed, dev, api, opt)
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
        want = ref.run_steps(cfg, traffic, seed, dev, drv.COMPARED, align=prog["align"])
        row = {"seed": seed}
        if args.program:
            row["program"] = drv.compare(prog, want)
            row["program_leaves"] = drv.leaf_gaps(prog, want)
            row["spectra"] = {"/".join(p): [float(t[1][0]), float(t[1][-1])]
                              for p, t in prog["trackers"].items()}
        if args.control:
            ctl = ref.run_steps(cfg, traffic, seed, dev, drv.COMPARED, fmt="float8",
                                align=prog["align"])
            row["control"] = drv.compare(ctl, want)
            row["control_leaves"] = drv.leaf_gaps(ctl, want)
        if args.faults:
            # the state left unchanged: the first moment nought, no change, the
            # trackers where they started
            start = {p: tuple(x.cpu() for x in t[:3])
                     for p, t in gin.make_trackers(cfg, traffic, seed, dev).items()}
            unchanged = {"trackers": start,
                         "seen_grad_norm": dict.fromkeys(prog["seen_grad_norm"], 0.0),
                         "change_norm": dict.fromkeys(prog["change_norm"], 0.0)}
            gaps = drv.leaf_gaps(unchanged, want)
            row["fault_unchanged"] = {"seen_grad": 1.0, "change": 1.0,
                                      "tracker": max(gaps["tracker"].values()),
                                      "tracker_sigma": max(gaps["tracker_sigma"].values())}
            half = _half_tokens(ref)
            try:
                bad = ref.run_steps(cfg, traffic, seed, dev, drv.COMPARED, align=prog["align"])
            finally:
                half()
            row["fault_half_tokens"] = drv.compare(bad, want)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)


def _half_tokens(ref):
    """Plant "half of the batch left out, the mean over the rest" in the
    reference: the loss over the first half of the positions.  Returns the
    undo."""
    saved = ref.loss

    def half_loss(params, batch, cfg, fmt="bfloat16"):
        s = batch["tokens"].shape[1] // 2
        return saved(params, {k: v[:, :s] for k, v in batch.items()}, cfg, fmt)

    ref.loss = half_loss
    return lambda: setattr(ref, "loss", saved)


def _svd(cell, seeds, args, dev):
    import torch

    from perfbench.inputs import svd_stream as sin
    from perfbench.reference import svd_stream as ref

    cfg, traffic = cell.config, cell.traffic
    for seed in seeds:
        t0 = time.perf_counter()
        checked = sin.sample_streams(cfg, traffic, seed)
        u0, s0, v0 = sin.make_states(cfg, traffic, seed, dev)
        sel = torch.tensor(checked, device=dev)
        pa, pb = (torch.from_numpy(x).to(dev) for x in sin.make_pool(cfg, traffic, seed, dev))
        idx = [sin.event_indices(cfg, traffic, i, args.events) for i in checked]
        want = ref.replay(u0[sel], s0[sel], v0[sel], pa, pb, idx)
        ctl = ref.replay(u0[sel], s0[sel], v0[sel], pa, pb, idx, dtype=torch.float32)
        print(json.dumps({"seed": seed, "events": args.events, "control": ref.gaps(ctl, want),
                          "seconds": time.perf_counter() - t0}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--events", type=int, default=2400, help="events a stream (service cells)")
    args = ap.parse_args(argv)
    import torch

    from perfbench.harness.device import require_cards

    cell = manifest.resolve(args.workload)
    require_cards(cell.chips)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    {"train_step": _granite, "svd_stream": _svd}[cell.traffic["driver"]](cell, seeds, args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
