"""The device trace of a traced stretch and what the per-layer readers take
from it.

``profile_stretch`` runs a stretch of the cell's own work under
``torch.profiler`` (host and CUDA activities) inside the span ``pb:traced``,
writes the Chrome trace to a file, and reduces it (``reduce_trace``):

* the traced window: the host span ``pb:traced``, which ends after a
  synchronize, so every device operation of the stretch lies inside it;
* ``busy_s``: the union of the device's kernel, copy and set intervals in the
  window (overlapping operations count once);
* ``device_ops``: device seconds by operation name, and ``launches`` by
  name, of the operations that began in the window;
* ``idle_gaps``: the device's idle seconds inside the window, summed by the
  innermost benchmark span (``pb:*``) open on the host when each gap began.

The benchmark's spans are ``torch.profiler.record_function`` ranges named
``pb:<what>``: they cost nothing while no profiler runs.
"""

from __future__ import annotations

import json
from pathlib import Path

SPAN_PREFIX = "pb:"
WINDOW_SPAN = "pb:traced"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def span(name: str):
    """A benchmark span (``pb:<name>``) in the trace."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


def profile_stretch(fn, path: Path) -> dict:
    """Run ``fn`` under the profiler, write its Chrome trace to ``path`` and
    return ``reduce_trace`` of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("traced"):
            fn()
            torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return reduce_trace(json.load(f))


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(trace: dict) -> dict:
    """The numbers of one traced stretch (times in seconds; see the module
    docstring).  ``window_s`` is 0 when the trace holds no ``pb:traced``."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") in ("user_annotation", "cpu_op")]
    if not windows:
        return {"window_s": 0.0, "busy_s": 0.0, "device_ops": {}, "launches": {},
                "idle_gaps": {}}
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])

    dev, ops, launches = [], {}, {}
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        dev.append((s, t))
        if float(e["ts"]) >= w0:
            # by name: the operations that began in the window (the stretch
            # ends with a synchronize, so they end in it too)
            ops[e["name"]] = ops.get(e["name"], 0.0) + (t - s) * 1e-6
            launches[e["name"]] = launches.get(e["name"], 0) + 1
    busy = _union(dev)
    busy_s = sum(t - s for s, t in busy) * 1e-6

    # host spans nest (one thread): a sweep keeps the open ones as a stack,
    # so each gap takes the innermost span open when it began
    spans = sorted((float(e["ts"]), -float(e["dur"]), e["name"]) for e in events
                   if e.get("cat") in ("user_annotation", "cpu_op")
                   and str(e.get("name", "")).startswith(SPAN_PREFIX) and e["name"] != WINDOW_SPAN)
    stack, nxt = [], 0

    def label(t: float) -> str:
        nonlocal nxt
        while nxt < len(spans) and spans[nxt][0] <= t:
            s0, neg_dur, name = spans[nxt]
            while stack and stack[-1][0] <= s0:
                stack.pop()
            stack.append((s0 - neg_dur, name))
            nxt += 1
        while stack and stack[-1][0] <= t:
            stack.pop()
        return stack[-1][1] if stack else "host outside any benchmark span"

    gaps, prev = {}, w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            name = label(prev)
            gaps[name] = gaps.get(name, 0.0) + (s - prev) * 1e-6
        prev = max(prev, t)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s, "device_ops": ops,
            "launches": launches, "idle_gaps": gaps}


def breakdown(red: dict) -> dict:
    """The contract's ``breakdown``: the ten device operations that took most
    time and the ten host spans under which the device idled longest."""
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"device_ops": top(red["device_ops"]), "idle_gaps": top(red["idle_gaps"])}


def idle_share(rec: dict):
    """The traced stretch's idle share of the card, in %: 100 (1 - busy /
    window); None without a trace."""
    red = rec.get("trace")
    if not red or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
