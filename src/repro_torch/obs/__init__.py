"""``repro_torch.obs`` — unified telemetry: metrics, span tracing, health probes.

Counterpart of ``repro.obs``, with the same names.

The observability layer for the whole stack (DESIGN.md §15).  Three parts:

* :mod:`repro_torch.obs.metrics` — process-global ``MetricsRegistry`` of typed
  counters/gauges/histograms with JSON + Prometheus-text exporters and
  per-shard label aggregation.
* :mod:`repro_torch.obs.trace` — nestable, thread-safe span tracing on the
  monotonic clock, emitting Chrome ``trace_event`` JSON
  (``chrome://tracing`` / Perfetto).
* :mod:`repro_torch.obs.health` — numerical-health probes in PyTorch
  (orthogonality drift, deflation fraction, secular residual, bf16
  headroom) with a sampling monitor + threshold watchdog.

Everything is OFF by default and the disabled path is free: library
instrumentation sites guard on ``obs.enabled()`` (one module-flag read),
``span()`` returns a shared no-op when tracing is off, and nothing ever
records between a kernel's inputs and its launch — update results and
launch counts are bitwise-independent of the obs state.

Quickstart::

    from repro_torch import obs

    obs.enable()                 # metrics on
    obs.start_tracing()          # spans on
    ... run traffic ...
    print(obs.registry().to_prometheus())
    obs.save_chrome_trace("trace.json")
"""

from __future__ import annotations

from repro_torch.obs.health import (
    DEFAULT_THRESHOLDS,
    HealthMonitor,
    HealthReport,
    HealthWarning,
    ortho_drift,
    probe_state,
    probe_update,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
    set_registry,
)
from repro_torch.obs.trace import (
    chrome_trace,
    clear_trace,
    save_chrome_trace,
    span,
    start_tracing,
    stop_tracing,
    trace_events,
    tracing,
)

__all__ = [
    "enabled",
    "enable",
    "disable",
    # metrics
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "set_registry",
    # trace
    "span",
    "start_tracing",
    "stop_tracing",
    "tracing",
    "trace_events",
    "clear_trace",
    "chrome_trace",
    "save_chrome_trace",
    # health
    "DEFAULT_THRESHOLDS",
    "HealthMonitor",
    "HealthReport",
    "HealthWarning",
    "ortho_drift",
    "probe_state",
    "probe_update",
]

_enabled = False


def enabled() -> bool:
    """Whether metric recording is on (the single hot-path gate)."""
    return _enabled


def enable() -> None:
    """Turn metric recording on (tracing is a separate switch)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False
