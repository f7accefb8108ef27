"""A profiler's Chrome trace reduced by the program's own spans.

With ``repro_torch.obs`` tracing on, every span of the program is a
``torch.profiler.record_function`` range named ``repro:<name>`` on the host,
on the profiler's clock.  ``reduce_program_trace`` lays the card's work and
the host's waits against those ranges.  Each quantity goes to the innermost
program span open on the host at the moment that decides it:

* ``launches`` and ``device_s``: the device operations (kernels, copies,
  sets), matched by ``args.correlation`` to the runtime call that launched
  them, by the time that call began;
* ``syncs``: the runtime calls in which the host blocks on the card
  (``SYNC_CALLS``; torch's ``.item()``, ``bool(tensor)`` and ``nonzero``
  wait in ``cudaStreamSynchronize``), by the time they began;
* ``idle_s``: the card's idle gaps, by the time each began.  The window runs
  from the first program span's start to the later of the last span's end
  and the end of the last device operation.

Each span name's figures are per traced step (the number of ``train_step``
ranges, or 1 without one): ``count`` (ranges), ``host_s`` (their duration),
the four quantities above summed over the span and every span inside it, and
under ``self`` the same without the spans inside it (``host_s`` less the
time its child spans cover).  What no program span holds is under
``outside``.
"""

from __future__ import annotations

PREFIX = "repro:"
STEP = "train_step"
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("user_annotation", "cpu_op")
QUANTITIES = ("launches", "device_s", "syncs", "idle_s")


def _ranges(events) -> list[tuple]:
    """The program's ranges as ``(start, end, name)``, outer before inner."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"][len(PREFIX):])
           for e in events
           if e.get("cat") in _HOST_CATS and str(e.get("name", "")).startswith(PREFIX)]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _stacks_at(ranges: list[tuple], times: list[float]) -> list[tuple]:
    """For each time, the names of the ranges open then, outer to inner (the
    ranges nest: they are one thread's spans)."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out: list = [()] * len(times)
    stack: list = []
    nxt = 0
    for i in order:
        t = times[i]
        while nxt < len(ranges) and ranges[nxt][0] <= t:
            s0, e0, name = ranges[nxt]
            while stack and stack[-1][0] <= s0:
                stack.pop()
            stack.append((e0, name))
            nxt += 1
        while stack and stack[-1][0] <= t:
            stack.pop()
        out[i] = tuple(name for _, name in stack)
    return out


def _self_host(ranges: list[tuple]) -> dict:
    """Per name, the ranges' time less the time their direct children cover."""
    own: dict = {}
    stack: list = []   # [start, end, name, time of the children]

    def close() -> None:
        s0, e0, name, child = stack.pop()
        own[name] = own.get(name, 0.0) + (e0 - s0) - child
        if stack:
            stack[-1][3] += e0 - s0

    for s0, e0, name in ranges:
        while stack and stack[-1][1] <= s0:
            close()
        stack.append([s0, e0, name, 0.0])
    while stack:
        close()
    return own


def reduce_program_trace(trace: dict) -> dict:
    """The trace's figures by program span (see the module docstring);
    ``{"steps": 0, ...}`` when it holds no program span."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ranges = _ranges(events)
    empty = {q: 0 for q in QUANTITIES}
    if not ranges:
        return {"steps": 0, "window_s": 0.0, "busy_s": 0.0, "spans": {}, "outside": empty}
    steps = sum(1 for r in ranges if r[2] == STEP) or 1

    calls = [e for e in events if e.get("cat") in _RUNTIME_CATS]
    call_stacks = _stacks_at(ranges, [float(e["ts"]) for e in calls])
    by_corr = {e["args"]["correlation"]: st for e, st in zip(calls, call_stacks)
               if "correlation" in e.get("args", {})}

    incl: dict = {}
    own: dict = {}
    outside = dict(empty)

    def add(stack: tuple, q: str, x: float) -> None:
        if not stack:
            outside[q] += x
            return
        own.setdefault(stack[-1], dict(empty))[q] += x
        for name in set(stack):
            incl.setdefault(name, dict(empty))[q] += x

    for e, st in zip(calls, call_stacks):
        if e["name"] in SYNC_CALLS:
            add(st, "syncs", 1)

    w0 = ranges[0][0]
    w1 = max(r[1] for r in ranges)
    dev = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        st = by_corr.get(e.get("args", {}).get("correlation"), ())
        add(st, "launches", 1)
        add(st, "device_s", (t - s) * 1e-6)
        if t > w0:
            dev.append((max(s, w0), t))
            w1 = max(w1, t)

    busy, prev, gaps = [], w0, []
    for s, t in sorted(dev):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s - prev))
        prev = max(prev, t)
    for (t0, d), st in zip(gaps, _stacks_at(ranges, [g[0] for g in gaps])):
        add(st, "idle_s", d * 1e-6)

    count: dict = {}
    host: dict = {}
    for s0, e0, name in ranges:
        count[name] = count.get(name, 0) + 1
        host[name] = host.get(name, 0.0) + (e0 - s0) * 1e-6
    self_host = _self_host(ranges)
    spans = {}
    for name in count:
        mine = incl.get(name, dict(empty))
        spans[name] = {"count": count[name] / steps, "host_s": host[name] / steps,
                       **{q: mine[q] / steps for q in QUANTITIES},
                       "self": {"host_s": self_host[name] * 1e-6 / steps,
                                **{q: own.get(name, empty)[q] / steps for q in QUANTITIES}}}
    return {"steps": steps, "window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6, "spans": spans,
            "outside": {q: outside[q] / steps for q in QUANTITIES}}
