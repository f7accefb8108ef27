"""The program's own spans over a stretch of a training cell's steps.

Since the port's ``train_step`` and the spectral-Adam path below it carry
spans of their own (``repro_torch.obs``: ``train_step`` > ``fwd_bwd``,
``optimizer`` > ``trackers`` > ``tracker_group`` > the phases of the
trackers' phase chain), a traced run also reads them, in a stretch of its
own after everything the driver measures (``run_stretch``):

* ``program_spans``: ``STEPS`` steps with ``obs.start_tracing(device=True)``
  and no profiler, each step's device ms by span name (spans of one name
  summed), from ``obs.device_times()``;
* ``program_trace``: ``PROFILED`` steps under the profiler with the
  program's tracing on, the Chrome trace written beside the driver's as
  ``<cell>.program.trace.json`` and reduced by
  ``harness.program_trace.reduce_program_trace``;
* ``dropped``: events the program's tracing dropped (its bound), which
  makes every reader of the stretch return None.

The stretch starts from the seed's weights and warm trackers, as the
driver's set-up does, runs ``WARM`` steps first, and holds the collector
over the device-timed steps, as the driver's window does.  ``readings(rec)``
is what the readers call: the driver's record when it holds the stretch's
keys, else, in a process of ``perfbench/run.py`` with ``--trace 1``, the
readings of one stretch run by ``main`` in a child process (cached): the
readers run after the driver has measured, reported its peak memory and
freed its state, and after its profiled steps, which slow every later
launch of their process.  Against a program without device-timed spans
(no ``obs.device_times``) it returns None and starts nothing.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

from perfbench.harness import manifest
from perfbench.harness.program_trace import reduce_program_trace

STEPS = 8       # two basis refreshes at basis_refresh_every 4
PROFILED = 2
WARM = 4        # as many as the driver's set-up runs before its window
TRACES = manifest.PERFBENCH / ".traces"
CHILD_TIMEOUT_S = 600
_CACHE: dict = {}


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def _by_step(times: list[dict]) -> list[dict]:
    """``obs.device_times()`` (enter order) as one ``{name: ms}`` a step,
    each step opened by its ``train_step`` span."""
    steps: list[dict] = []
    for t in times:
        if t["name"] == "train_step":
            steps.append({})
        if steps:
            steps[-1][t["name"]] = steps[-1].get(t["name"], 0.0) + t["ms"]
    return steps


def run_stretch(cell, seed: int, device, trace_path: Path) -> dict | None:
    """The stretch on ``cell`` (a training cell) from ``seed``, the profiled
    steps' Chrome trace written to ``trace_path``; None when the program has
    no device-timed spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness.host import collector_held
    from perfbench.inputs import granite as gin
    from repro_torch import obs
    from repro_torch.train import loop

    if not hasattr(obs, "device_times"):
        return None
    _log(f"the program's spans: {WARM} + {STEPS} steps, {PROFILED} under the profiler")
    drv = manifest.driver(cell.traffic["driver"])
    cfg, traffic = cell.config, cell.traffic
    api, opt = drv.program(cfg, traffic)
    params = gin.make_weights(cfg, seed, device)
    holder = {"params": params, "state": drv.build_state(cfg, traffic, params, seed, device),
              "step": 0}
    del params
    batches = gin.Batches(cfg, seed, device)

    def steps(n: int) -> None:
        for _ in range(n):
            holder["params"], holder["state"], _, _ = loop.train_step(
                api, opt, holder["params"], holder["state"], batches.next(), holder["step"],
                spectral=True)
            holder["step"] += 1

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out: dict = {"steps": STEPS, "profiled_steps": PROFILED}
    try:
        steps(WARM)
        sync()
        obs.clear_trace()
        with collector_held():
            obs.start_tracing(device=True)
            steps(STEPS)
            obs.stop_tracing()
        out["program_spans"] = _by_step(obs.device_times())
        dropped = obs.dropped_events()

        obs.clear_trace()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync()
        obs.start_tracing()
        try:
            with profile(activities=acts) as prof:
                steps(PROFILED)
                sync()
        finally:
            obs.stop_tracing()
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        with open(trace_path) as f:
            out["program_trace"] = reduce_program_trace(json.load(f))
        out["dropped"] = dropped + obs.dropped_events()
    finally:
        obs.stop_tracing()
        obs.clear_trace()
        del holder, batches
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def _run_args():
    """``(workload, seed)`` of this process when it is a traced
    ``perfbench/run.py`` run, else None."""
    if Path(sys.argv[0]).name != "run.py":
        return None
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--trace", type=int, default=0)
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None or not args.trace:
        return None
    return args.workload, args.seed


def _child(workload: str, seed: int) -> dict | None:
    """The stretch in a process of its own (``main``): a ``torch.profiler``
    session with CUDA activity leaves every later launch of its process
    slower (the trackers by ~30 % on an H100), and the driver's profiled
    stretch has run in this one."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    path = TRACES / f"{manifest.resolve(workload).name}.program.json"
    path.unlink(missing_ok=True)
    res = subprocess.run([sys.executable, "-m", "perfbench.harness.program_stretch",
                          "--workload", workload, "--seed", str(seed)],
                         cwd=manifest.ROOT, stdout=sys.stderr, timeout=CHILD_TIMEOUT_S)
    if res.returncode != 0 or not path.exists():
        _log(f"the program's stretch exited {res.returncode}; its metrics are left out")
        return None
    return json.loads(path.read_text())


def readings(rec: dict) -> dict | None:
    """The stretch's readings for a traced run (see the module docstring)."""
    if "program_spans" in rec:
        return rec
    key = _run_args()
    if key is None:
        return None
    if key not in _CACHE:
        import torch

        from repro_torch import obs

        cell = manifest.resolve(key[0])
        if (cell.traffic.get("driver") != "train_step" or not torch.cuda.is_available()
                or not hasattr(obs, "device_times")):
            _CACHE[key] = None
        else:
            # a reader runs after the driver's readings: a fault of the stretch
            # leaves its metrics out of the line and the run's result standing
            try:
                _CACHE[key] = _child(*key)
            except (subprocess.SubprocessError, OSError, ValueError) as e:
                _log(f"the program's stretch failed: {e!r}")
                _CACHE[key] = None
    return _CACHE[key]


def main(argv=None) -> int:
    """The child of ``readings``: the stretch on the card, its readings
    written to ``perfbench/.traces/<cell>.program.json``."""
    ap = argparse.ArgumentParser(description="the program's spans over a training cell's steps")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    src = str(manifest.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    cell = manifest.resolve(args.workload)
    torch.cuda.set_device(0)
    out = run_stretch(cell, args.seed, torch.device("cuda", 0),
                      TRACES / f"{cell.name}.program.trace.json")
    if out is None:
        return 1
    (TRACES / f"{cell.name}.program.json").write_text(json.dumps(out, indent=1))
    return 0


def span_ms(rec: dict, name: str, less: str | None = None):
    """The mean over the stretch's steps of span ``name``'s device ms (less
    span ``less``'s); None without a clean stretch or a step with the span."""
    got = readings(rec)
    if not got or got.get("dropped"):
        return None
    steps = [s for s in got["program_spans"] if name in s]
    if not steps:
        return None
    return sum(s[name] - s.get(less, 0.0) for s in steps) / len(steps)


def traced(rec: dict, name: str, quantity: str):
    """Span ``name``'s ``quantity`` a step in the profiled steps (see
    ``reduce_program_trace``); None without a clean stretch or the span."""
    got = readings(rec)
    if not got or got.get("dropped"):
        return None
    spans = got["program_trace"]["spans"]
    return spans[name][quantity] if name in spans else None


if __name__ == "__main__":
    sys.exit(main())
