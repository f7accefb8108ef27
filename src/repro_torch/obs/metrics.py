"""Process-global metrics registry (DESIGN.md §15).

The port's own copy of ``repro.obs.metrics``, which is free of any framework:
the same series names, JSON and Prometheus text and ``snapshot``/``restore``
rows, so that a registry captured by either package restores in the other.

One ``MetricsRegistry`` per process holds every counter/gauge/histogram the
system emits — serve flush accounting, fleet per-shard counters, engine and
planner cache hit/miss, numerical-health gauges.  Three rules keep it
production-shaped:

* **Zero overhead when disabled.**  The registry exists either way, but every
  instrumentation site in the library guards on ``repro_torch.obs.enabled()``
  — a single module-flag read — so the default (disabled) configuration adds
  no locks, no allocations and no dict lookups to hot paths.  Nothing is
  ever recorded between a kernel's inputs and its launch, so results and
  launch counts are independent of the obs state.

* **Allocation-free hot path when enabled.**  Metric handles are created
  once (``registry().counter(name)``) and cached by the call site; ``inc``
  / ``set`` / ``observe`` mutate preallocated slots (histograms are
  fixed-bucket int lists — no per-observation allocation).

* **Labels are first-class.**  ``counter(name, shard="3")`` returns an
  independent child series; exporters render the label sets and
  ``aggregate(name)`` sums across them (the fleet rolls per-shard series
  into fleet totals this way).

Exporters: ``to_json()`` (machine-readable snapshot, also the
snapshot/restore wire format) and ``to_prometheus()`` (text exposition
format v0.0.4 — ``# TYPE`` lines, ``_total``/``_bucket`` conventions).
"""

from __future__ import annotations

import json
import threading
from typing import Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "set_registry",
    "DEFAULT_BUCKETS_US",
]

# Latency-flavored default buckets (microseconds): 10us .. 10s, log-ish.
DEFAULT_BUCKETS_US = (
    10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4, 1e5, 2.5e5, 5e5, 1e6, 1e7,
)


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labels_text(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter.  ``inc`` is the only mutator."""

    __slots__ = ("name", "labels", "_value", "_lock")
    kind = "counter"

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _state(self):
        return self._value

    def _restore(self, state) -> None:
        self._value = int(state)


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "labels", "_value", "_lock")
    kind = "gauge"

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, x: float) -> None:
        with self._lock:
            self._value = float(x)

    def max(self, x: float) -> None:
        """Keep the running maximum (peak gauges)."""
        with self._lock:
            if x > self._value:
                self._value = float(x)

    @property
    def value(self) -> float:
        return self._value

    def _state(self):
        return self._value

    def _restore(self, state) -> None:
        self._value = float(state)


class Histogram:
    """Fixed-bucket histogram — cumulative-bucket semantics on export.

    Bucket bounds are frozen at construction; ``observe`` does a linear
    scan over a small tuple and bumps one preallocated int slot (no
    allocation, no resize).  Tracks count/sum for mean and a running max.
    """

    __slots__ = ("name", "labels", "bounds", "_counts", "_count", "_sum",
                 "_max", "_lock")
    kind = "histogram"

    def __init__(self, name: str, labels: tuple = (),
                 bounds: Iterable[float] = DEFAULT_BUCKETS_US):
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds must be sorted: {self.bounds}")
        self._counts = [0] * (len(self.bounds) + 1)   # +1: +Inf bucket
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        x = float(x)
        i = 0
        for b in self.bounds:          # small fixed tuple — no bisect alloc
            if x <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += x
            if x > self._max:
                self._max = x

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def value(self) -> dict:
        return {"count": self._count, "sum": self._sum, "max": self._max,
                "counts": list(self._counts)}

    def _state(self):
        return {"bounds": list(self.bounds), "counts": list(self._counts),
                "count": self._count, "sum": self._sum, "max": self._max}

    def _restore(self, state) -> None:
        if list(state["bounds"]) != list(self.bounds):
            # bound mismatch across versions: keep count/sum, drop buckets
            self._counts = [0] * (len(self.bounds) + 1)
        else:
            self._counts = [int(c) for c in state["counts"]]
        self._count = int(state["count"])
        self._sum = float(state["sum"])
        self._max = float(state.get("max", 0.0))


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe home for every metric series in the process.

    Series are keyed by ``(name, sorted-label-tuple)``; the first
    ``counter``/``gauge``/``histogram`` call for a key creates the series,
    later calls return the same object (cache the handle at the call site
    for hot paths).  Asking for an existing name with a different kind is
    an error — one name, one type, as in Prometheus.
    """

    def __init__(self):
        self._series: dict[tuple, object] = {}
        self._lock = threading.Lock()
        # bumped on reset() so call sites holding cached handles can tell
        # their series were dropped and must re-fetch
        self.generation = 0

    # -- handle creation ----------------------------------------------------

    def _get(self, kind: str, name: str, labels: dict, **kw):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = _KINDS[kind](name, key[1], **kw)
                self._series[key] = m
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, *, bounds=DEFAULT_BUCKETS_US, **labels) -> Histogram:
        return self._get("histogram", name, labels, bounds=bounds)

    # -- read side ----------------------------------------------------------

    def series(self) -> list:
        with self._lock:
            return sorted(self._series.values(),
                          key=lambda m: (m.name, m.labels))

    def get(self, name: str, **labels):
        """The series for (name, labels), or None if never recorded."""
        return self._series.get((name, _labels_key(labels)))

    def aggregate(self, name: str) -> float:
        """Sum of a metric across all its label sets (counters/gauges) —
        the fleet-total view of per-shard series."""
        total = 0.0
        for m in self.series():
            if m.name == name and m.kind in ("counter", "gauge"):
                total += m.value
        return total

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self.generation += 1

    # -- snapshot / restore (rides ServiceSnapshot / FleetSnapshot) ---------

    def snapshot(self, prefix: str | None = None) -> tuple:
        """Deterministic state of every series (optionally only those whose
        name starts with ``prefix``) — the payload that rides service/fleet
        snapshots.  Rows are fully hashable ``(name, labels, kind,
        json-state)`` tuples, so they can live in pytree metadata."""
        rows = []
        for m in self.series():
            if prefix is not None and not m.name.startswith(prefix):
                continue
            rows.append((m.name, m.labels, m.kind, json.dumps(m._state())))
        return tuple(rows)

    def restore(self, rows) -> None:
        """Merge a ``snapshot()`` payload back in (overwrites same-key
        series, leaves unrelated series alone).  Accepts list-shaped rows
        too (the aux-spec JSON round trip turns tuples into lists)."""
        for name, labels, kind, state in rows:
            state = json.loads(state) if isinstance(state, str) else state
            kw = {}
            if kind == "histogram" and isinstance(state, dict) and "bounds" in state:
                # recreate with the SAVED bounds (a fresh-process restore has
                # no call site to have fixed them yet)
                kw["bounds"] = tuple(state["bounds"])
            m = self._get(kind, name,
                          dict((str(k), str(v)) for k, v in labels), **kw)
            m._restore(state)

    # -- exporters ----------------------------------------------------------

    def to_json(self, indent: int | None = None) -> str:
        rows = [
            {"name": m.name, "labels": dict(m.labels), "kind": m.kind,
             "value": m.value}
            for m in self.series()
        ]
        return json.dumps(rows, indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        by_name: dict[str, list] = {}
        for m in self.series():
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = group[0].kind
            base = _sanitize(name)
            if kind == "counter" and not base.endswith("_total"):
                base += "_total"
            lines.append(f"# TYPE {base} {kind}")
            for m in group:
                lt = _labels_text(m.labels)
                if kind in ("counter", "gauge"):
                    lines.append(f"{base}{lt} {_fmt(m.value)}")
                else:
                    cum = 0
                    for bound, c in zip(m.bounds, m._counts):
                        cum += c
                        blt = _bucket_labels(m.labels, _fmt(bound))
                        lines.append(f"{base}_bucket{blt} {cum}")
                    cum += m._counts[-1]
                    blt = _bucket_labels(m.labels, "+Inf")
                    lines.append(f"{base}_bucket{blt} {cum}")
                    lines.append(f"{base}_sum{lt} {_fmt(m.sum)}")
                    lines.append(f"{base}_count{lt} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(x) -> str:
    if isinstance(x, bool):
        return "1" if x else "0"
    if isinstance(x, int):
        return str(x)
    f = float(x)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _bucket_labels(labels: tuple, le: str) -> str:
    return _labels_text(labels + (("le", le),))


# ---------------------------------------------------------------------------
# Process-global registry
# ---------------------------------------------------------------------------

_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every library site records into."""
    return _registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous one."""
    global _registry
    prev = _registry
    _registry = reg
    return prev
