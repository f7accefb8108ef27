"""Readings the limits of ``correct`` are set from, for the training cells of
``drivers/train_model.py`` (``perfbench/control.py`` does the same for
``drivers/train_step.py``'s): the program's numbers on many seeds, the
control's, and planted faults', at the cell's own size.  Not run by the
benchmark's own runs.

    python3 perfbench/control_model.py --workload <cell> --seeds 11,12,13 [--program] [--control] [--faults]

Per seed, ``--program`` drives the program's state through the compared
steps (the run's own set-up, no window) and compares it with the reference;
``--control`` puts the reference computed with float8 products (the
precision below the configuration's bfloat16) in the program's place;
``--faults`` puts there the reference with half of each batch's tokens left
out of the loss (the mean over the rest), and reads what a state left
unchanged gives (1 on ``seen_grad`` and ``change`` by their definition; on
the trackers the gaps of the starting ones).  Every reading is printed as
one JSON line.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from perfbench.control import _half_tokens  # noqa: E402
from perfbench.harness import manifest  # noqa: E402


def readings(cell, seed: int, dev, *, program=True, control=False, faults=False) -> dict:
    import torch

    drv = manifest.driver("train_model")
    gaps = manifest.driver("train_step").leaf_gaps
    cfg, traffic = cell.config, cell.traffic
    inputs, model = drv.modules(cfg)
    api, opt = drv.program(cfg, traffic)
    stepper, prog = drv.program_readings(cfg, traffic, seed, dev, api, opt)
    del stepper
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    align = prog["align"]
    want = drv.reference(cfg, traffic, seed, dev, align=align)
    row = {"seed": seed}
    if program:
        row["program"] = drv.compare(prog, want, traffic)
    if control:
        ctl = drv.reference(cfg, traffic, seed, dev, fmt="float8", align=align)
        row["control"] = drv.compare(ctl, want, traffic)
    if faults:
        row["fault_unchanged"] = {"seen_grad": 1.0, "change": 1.0}
        if drv.spectral(traffic):
            start = {p: tuple(x.cpu() for x in t[:3])
                     for p, t in inputs.make_trackers(cfg, traffic, seed, dev).items()}
            unchanged = {"trackers": start,
                         "seen_grad_norm": dict.fromkeys(prog["seen_grad_norm"], 0.0),
                         "change_norm": dict.fromkeys(prog["change_norm"], 0.0)}
            row["fault_unchanged"]["tracker_sigma"] = max(
                gaps(unchanged, want)["tracker_sigma"].values())
        undo = _half_tokens(model)
        try:
            bad = drv.reference(cfg, traffic, seed, dev, align=align)
        finally:
            undo()
        row["fault_half_tokens"] = drv.compare(bad, want, traffic)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from perfbench.harness.device import require_cards

    cell = manifest.resolve(args.workload)
    if cell.traffic["driver"] != "train_model":
        raise SystemExit(f"{args.workload} is not a cell of drivers/train_model.py")
    require_cards(cell.chips)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = readings(cell, seed, dev, program=args.program, control=args.control,
                       faults=args.faults)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
