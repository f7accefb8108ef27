"""Nestable span tracing → Chrome ``trace_event`` JSON (DESIGN.md §15).

The port's counterpart of ``repro.obs.trace``: the same spans, events and
exporters, and two things the reference's host spans cannot give.

``span("flush_round")`` wraps a region of the program; spans nest naturally
(reap inside flush inside pump; the trackers' phases inside a train step),
are thread-safe (one buffer, per-thread ``tid``), and with tracing on each
one is three things at once:

* a HOST event on the monotonic clock (``perf_counter_ns``, immune to
  wall-clock steps): one Chrome complete event (``"ph": "X"``, ``ts``/``dur``
  in microseconds), so ``chrome://tracing`` / Perfetto render the timeline.
  Kernel launches are asynchronous, so the host event of a span around
  device work measures the time to ENQUEUE it, not the device's time;
* a PROFILER RANGE, ``torch.profiler.record_function("repro:<name>")``, open
  for the span's lifetime: under any ``torch.profiler`` session the spans lie
  in the exported trace beside the card's kernels and the runtime calls, on
  the profiler's own clock (no profiler: the range records nothing);
* with ``start_tracing(device=True)`` on a CUDA machine, DEVICE TIME: a pair
  of CUDA events (from a reused pool) recorded on the current stream at enter
  and exit, read only by ``device_times()``, which synchronizes once.  No
  event is recorded while the current stream captures a CUDA graph, so a
  captured region stays capturable.  Off CUDA the flag is ignored.

Contract with the rest of the library:

* When tracing is off (the default) ``span()`` returns a shared no-op
  context manager — no clock read, no allocation, no lock, no profiler
  range, no CUDA event.
* Tracing never touches a tensor and launches nothing, so results and launch
  counts are bitwise the same with it on or off.
* Memory is bounded: past ``_MAX_EVENTS`` host events (or pending device
  pairs) further ones are dropped and counted (``dropped_events()``, and
  ``chrome_trace()``'s ``otherData``), so a reader can refuse a truncated
  trace.
* On span exit the duration is also fed to the metrics registry as a
  ``span_duration_us`` histogram labeled by span name (when metrics are
  enabled), so Prometheus sees the same taxonomy the trace file does.
"""

from __future__ import annotations

import json
import threading
import time

import torch

from repro_torch.obs import metrics as _metrics

__all__ = [
    "span",
    "start_tracing",
    "stop_tracing",
    "tracing",
    "trace_events",
    "clear_trace",
    "save_chrome_trace",
    "chrome_trace",
    "device_times",
    "dropped_events",
    "RANGE_PREFIX",
]

RANGE_PREFIX = "repro:"        # the profiler range of span ``x`` is ``repro:x``

_lock = threading.Lock()
_events: list[dict] = []
_tracing = False
_device = False                # CUDA event pairs on spans (start_tracing(device=True))
_MAX_EVENTS = 200_000          # drop (and count) beyond this — bounded memory
_dropped = 0
_pending: list[list] = []      # device spans in enter order: [name, args, ev0, ev1 | None]
_pool: list = []               # CUDA events read by device_times(), for reuse


def tracing() -> bool:
    """True while span collection is on."""
    return _tracing


def start_tracing(device: bool = False) -> None:
    """Turn spans on; ``device=True`` also times each span on the card (a
    pair of CUDA events, see ``device_times``), ignored without CUDA."""
    global _tracing, _device
    _device = bool(device) and torch.cuda.is_available()
    _tracing = True


def stop_tracing() -> None:
    """Turn spans off; device spans already recorded stay readable."""
    global _tracing, _device
    _tracing = False
    _device = False


def clear_trace() -> None:
    """Forget every host event and device span, and the dropped count."""
    global _dropped
    with _lock:
        _events.clear()
        _pending.clear()
        _dropped = 0


def trace_events() -> list[dict]:
    """A copy of the collected Chrome events."""
    with _lock:
        return list(_events)


def dropped_events() -> int:
    """Host events and device spans dropped past ``_MAX_EVENTS`` since the
    last ``clear_trace()``."""
    return _dropped


def device_times() -> list[dict]:
    """Each completed device-timed span, in the order the spans were entered,
    as ``{"name", "ms", "args"}`` (``ms``: the card's time from the span's
    enter to its exit on the stream it was entered on).  Synchronizes once;
    the spans read are forgotten and their events reused.  Spans still open
    stay for a later call."""
    with _lock:
        done = [r for r in _pending if r[3] is not None]
        _pending[:] = [r for r in _pending if r[3] is None]
    if not done:
        return []
    torch.cuda.synchronize()
    out = [{"name": name, "ms": ev0.elapsed_time(ev1), "args": dict(args)}
           for name, args, ev0, ev1 in done]
    with _lock:
        _pool.extend(ev for r in done for ev in r[2:])
    return out


def _record_event():
    """A pooled CUDA event recorded on the current stream."""
    with _lock:
        ev = _pool.pop() if _pool else None
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """Live span: on enter the host clock, the profiler range and (device
    tracing) the first event; on exit the same in reverse, one 'X' event.

    ``set(key=value)`` attaches args visible in the trace viewer (merge
    levels attach pair counts and wire bytes this way).
    """

    __slots__ = ("name", "args", "_t0", "_range", "_dev")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def set(self, **kw) -> "_Span":
        self.args.update(kw)
        return self

    def __enter__(self) -> "_Span":
        global _dropped
        self._t0 = time.perf_counter_ns()
        self._range = torch.profiler.record_function(RANGE_PREFIX + self.name)
        self._range.__enter__()
        self._dev = None
        if _device and not torch.cuda.is_current_stream_capturing():
            rec = [self.name, self.args, _record_event(), None]
            with _lock:
                if len(_pending) < _MAX_EVENTS:
                    _pending.append(rec)
                    self._dev = rec
                else:
                    _dropped += 1
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        if self._dev is not None:
            self._dev[3] = _record_event()
        self._range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        ts_us = self._t0 / 1e3
        dur_us = (t1 - self._t0) / 1e3
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": 1,
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if self.args:
            ev["args"] = dict(self.args)
        with _lock:
            if len(_events) < _MAX_EVENTS:
                _events.append(ev)
            else:
                _dropped += 1
        from repro_torch import obs as _obs
        if _obs.enabled():
            _span_histogram(self.name).observe(dur_us)


_hist_cache: dict = {"key": None, "by_name": {}}


def _span_histogram(name: str):
    """Per-span-name ``span_duration_us`` handle, cached across the hot
    path (invalidated when the registry is swapped or reset)."""
    reg = _metrics.registry()
    key = (reg, reg.generation)
    if _hist_cache["key"] != key:
        _hist_cache["key"] = key
        _hist_cache["by_name"] = {}
    by_name = _hist_cache["by_name"]
    h = by_name.get(name)
    if h is None:
        h = by_name[name] = reg.histogram("span_duration_us", span=name)
    return h


class _NoopSpan:
    """Shared do-nothing span — the disabled-path singleton."""

    __slots__ = ()

    def set(self, **kw) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopSpan()


def span(name: str, **args):
    """Context manager bracketing one named region.

    >>> from repro_torch import obs
    >>> obs.start_tracing()
    >>> with obs.span("flush_round", batch=4) as sp:
    ...     _ = sp.set(depth=1)
    >>> obs.stop_tracing()
    >>> [e["name"] for e in obs.trace_events()]
    ['flush_round']
    """
    if not _tracing:
        return _NOOP
    return _Span(name, args)


def chrome_trace() -> str:
    """The collected spans as a Chrome ``trace_event`` JSON document; its
    ``otherData`` says how many events were dropped (``dropped_events()``)."""
    with _lock:
        evs, dropped = list(_events), _dropped
    return json.dumps({"traceEvents": evs, "displayTimeUnit": "ms",
                       "otherData": {"dropped_events": dropped}})


def save_chrome_trace(path) -> str:
    """Write the Chrome trace JSON to ``path``; returns the path written."""
    doc = chrome_trace()
    with open(path, "w") as f:
        f.write(doc)
    return str(path)
