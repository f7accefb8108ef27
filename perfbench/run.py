"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run loads the cell (``perfbench.harness.manifest``), makes its inputs
from ``--seed``, warms the cell's own shapes, measures for ``--seconds``,
decides ``correct`` by the plain reference, and prints one JSON object as
the last line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics (each read by
``layer_metrics/<metric>.py``) and the traced stretch's ``busy_s``,
``window_s`` and ``breakdown``.  Each number compared is printed beside its
limit as the last lines of standard error and under ``checks``, the line's
last key.

A run without enough CUDA cards, or one that finds JAX or the JAX package
loaded once the window has closed, exits with a non-zero code and prints no
result.  The program's compile caches live at fixed paths inside the
checkout: its nvcc libraries under ``build/repro_torch/`` (the port's own
rule) and ``TRITON_CACHE_DIR`` / ``TORCH_EXTENSIONS_DIR`` under
``perfbench/.cache/``; the traced run writes its Chrome trace and readings
under ``perfbench/.traces/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.harness import device as hdev  # noqa: E402
from perfbench.harness import manifest  # noqa: E402
from perfbench.harness.trace import breakdown  # noqa: E402

TRACES = HERE / ".traces"


class Context:
    """What a driver is given: the cell, the run's arguments, the device, where
    the traced run writes its trace, and ``window_start(t)`` to call with the
    host clock when the measured window opens (set-up ends there)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, log=None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.trace_path = TRACES / f"{cell.name}.trace.json"
        self.t_window = None
        self.log = log or (lambda msg: print(f"[perfbench] {msg}", file=sys.stderr, flush=True))

    def window_start(self, t: float) -> None:
        self.t_window = t


def checks_of(numbers: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}``: every number the driver compared
    beside its limit from the cell's limits file (each must have one)."""
    if set(numbers) != set(limits["limits"]):
        raise RuntimeError(f"the driver's numbers {sorted(numbers)} and the limits file's "
                           f"{sorted(limits['limits'])} differ")
    return {k: {"value": numbers[k], "limit": limits["limits"][k]["limit"]} for k in numbers}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result_line(cell, out: dict, setup_s: float, trace: bool, power_w, kind: str) -> dict:
    checks = checks_of(out["numbers"], cell.limits)
    metrics = {}
    if not trace:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the driver gave no {m['name']!r}")
            metrics[m["name"]] = {"value": _finite(values[m["name"]]), "unit": m["unit"]}
    else:
        rec = dict(out["rec"], trace=out["trace"], power_limit_w=power_w)
        for m in cell.per_layer:
            value = manifest.layer_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"]), "power_limit_w": power_w}
    line = {"correct": bool(passes(checks) and out["failed"] == 0),
            "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": metrics, "device": dev}
    if trace and out["trace"] is not None:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = breakdown(out["trace"])
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # fixed cache directories inside the checkout, before torch is imported
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"

    cell = manifest.resolve(args.workload)
    try:
        hdev.require_cards(cell.chips)
    except hdev.NoCard as e:
        print(f"[perfbench] {e}", file=sys.stderr)
        return 2
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), dev)
    power_w = hdev.power_limit_w()
    kind = hdev.card_name()
    ctx.log(f"{cell.name} seed {args.seed} on {kind}, power limit {power_w} W")
    out = manifest.driver(cell.traffic["driver"]).run(ctx)
    if ctx.t_window is None:
        raise RuntimeError("the driver never opened its window")
    setup_s = ctx.t_window - T_START

    loaded = hdev.forbidden_modules_loaded()
    if loaded:
        print(f"[perfbench] the run loaded {loaded}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, setup_s, ctx.trace, power_w, kind)
    if ctx.trace:
        TRACES.mkdir(parents=True, exist_ok=True)
        (TRACES / f"{cell.name}.rec.json").write_text(json.dumps(
            {"rec": out["rec"], "line": line}, default=str, indent=1))
    ctx.log(f"setup_s {setup_s:.3f}; " + "; ".join(
        f"{k} {v['value']}" for k, v in line["metrics"].items()))
    for name, c in line["checks"].items():
        print(f"[perfbench] check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
