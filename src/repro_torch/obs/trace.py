"""Nestable span tracing → Chrome ``trace_event`` JSON (DESIGN.md §15).

The port's own copy of ``repro.obs.trace`` (free of any framework).

``span("flush_round")`` wraps a region of host-side control flow; spans nest
naturally (reap inside flush inside pump), are thread-safe (one buffer,
per-thread ``tid``), and run on the monotonic clock (``perf_counter_ns`` —
immune to wall-clock steps).  Each completed span is one Chrome complete
event (``"ph": "X"``, ``ts``/``dur`` in microseconds) so
``chrome://tracing`` / Perfetto render the flush/merge timeline directly.

Contract with the rest of the library:

* When tracing is off (the default) ``span()`` returns a shared no-op
  context manager — no clock read, no allocation, no lock.
* Spans are HOST spans: they time the host's control flow on its monotonic
  clock.  Kernel launches are asynchronous, so a span around a dispatch
  measures the time to ENQUEUE the work, not the device's time to run it
  (as in the reference, where a span around an async dispatch does the
  same); the device's time shows in the ``reap`` span of the round that
  waits for it.  Tracing never touches a tensor, so it cannot change a
  result.
* On span exit the duration is also fed to the metrics registry as a
  ``span_duration_us`` histogram labeled by span name (when metrics are
  enabled), so Prometheus sees the same taxonomy the trace file does.
"""

from __future__ import annotations

import json
import threading
import time

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
]

_lock = threading.Lock()
_events: list[dict] = []
_tracing = False
_MAX_EVENTS = 200_000          # drop (and count) beyond this — bounded memory


def tracing() -> bool:
    """True while span collection is on."""
    return _tracing


def start_tracing() -> None:
    global _tracing
    _tracing = True


def stop_tracing() -> None:
    global _tracing
    _tracing = False


def clear_trace() -> None:
    with _lock:
        _events.clear()


def trace_events() -> list[dict]:
    """A copy of the collected Chrome events."""
    with _lock:
        return list(_events)


class _Span:
    """Live span: records ts on enter, emits one 'X' event on exit.

    ``set(key=value)`` attaches args visible in the trace viewer (merge
    levels attach pair counts and wire bytes this way).
    """

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def set(self, **kw) -> "_Span":
        self.args.update(kw)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
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
    """The collected spans as a Chrome ``trace_event`` JSON document."""
    with _lock:
        evs = list(_events)
    return json.dumps({"traceEvents": evs, "displayTimeUnit": "ms"})


def save_chrome_trace(path) -> str:
    """Write the Chrome trace JSON to ``path``; returns the path written."""
    doc = chrome_trace()
    with open(path, "w") as f:
        f.write(doc)
    return str(path)
