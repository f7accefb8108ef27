"""Numerical-health probes + watchdog (DESIGN.md §15), in PyTorch.

Counterpart of ``repro.obs.health``.  The probes compute, from factors the
serving path already holds (no dense reconstruction, no reference SVD):

* ``ortho_drift``        max(‖UᵀU−I‖_max, ‖VᵀV−I‖_max)
* ``deflation_fraction`` fraction of secular coordinates whose coupling
                         z_i = (Uᵀa)_i (Vᵀb)_i falls under the deflation
                         tolerance
* ``secular_residual``   max_i |(U₁ᵀ(U₀S₀V₀ᵀ + abᵀ)V₁)_ii − s₁_i| / s₁_max,
                         factored in O((m+n)r²)
* ``bf16_headroom``      the bf16 ``sigma_rel`` budget minus the measured
                         drift floor (storage-dtype quantization of the
                         spectrum, or ortho drift if larger)

Every probe is a separate function over the SAME tensors the service just
flushed, run on their device after the update's launches: enabling probes
cannot change an update's result or its launches.  A probe reads its gauges
to the host (one synchronisation) only when ``HealthMonitor`` says it is
due: with ``UpdatePolicy.health_every=None`` or observability disabled the
service calls no probe at all.  ``HealthMonitor`` publishes gauges into the
metrics registry and raises ``HealthWarning`` (plus a
``health_warnings_total`` counter) when a threshold trips.
"""

from __future__ import annotations

import threading
import warnings
from typing import NamedTuple

import torch

from repro_torch.obs import metrics as _metrics

__all__ = [
    "DEFAULT_THRESHOLDS",
    "HealthReport",
    "HealthMonitor",
    "HealthWarning",
    "ortho_drift",
    "probe_state",
    "probe_update",
]


class HealthWarning(RuntimeWarning):
    """A numerical-health gauge crossed its configured threshold."""


class HealthReport(NamedTuple):
    """One sample of the health gauges (host floats, registry-ready)."""

    ortho_drift: float
    deflation_fraction: float
    secular_residual: float
    bf16_headroom: float


# Gauges are "worse when larger" except bf16_headroom ("worse when smaller").
# The reference's defaults: they flag broken states, not working-precision
# noise (f32 serving sits around 1e-6 drift, f64 around 1e-14).
DEFAULT_THRESHOLDS = {
    "ortho_drift": 1e-3,
    "secular_residual": 1e-3,
    "bf16_headroom": 0.0,        # lower bound: warn at/below zero headroom
}
_LOWER_IS_BAD = frozenset({"bf16_headroom"})

# sigma_rel budget for bf16 storage (the reference's BF16_ERROR_BUDGET)
_BF16_SIGMA_BUDGET = 5e-2


def _compute(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype.itemsize <= 2 else x


def ortho_drift(u, v) -> torch.Tensor:
    """max(‖UᵀU−I‖_max, ‖VᵀV−I‖_max) for one state's factors, as a 0-d
    tensor on their device (no synchronisation)."""
    uf, vf = _compute(u), _compute(v)
    r_u = torch.eye(uf.shape[-1], dtype=uf.dtype, device=uf.device) - uf.mT @ uf
    r_v = torch.eye(vf.shape[-1], dtype=vf.dtype, device=vf.device) - vf.mT @ vf
    return torch.maximum(r_u.abs().amax(), r_v.abs().amax())


def _probe_update_tensors(u0, s0, v0, a, b, u1, s1, v1, rtol: float):
    cd = torch.float32 if u0.dtype.itemsize <= 2 else u0.dtype
    u0f, v0f, s0f = u0.to(cd), v0.to(cd), s0.to(cd)
    u1f, v1f, s1f = u1.to(cd), v1.to(cd), s1.to(cd)
    af, bf = a.to(device=u0.device, dtype=cd), b.to(device=u0.device, dtype=cd)

    drift = ortho_drift(u1, v1)

    # deflation coupling on the pre-update basis: z_i = (U0^T a)_i (V0^T b)_i
    z = (u0f.mT @ af) * (v0f.mT @ bf)
    zmax = z.abs().amax()
    tiny = torch.finfo(cd).tiny
    defl = (z.abs() <= rtol * (zmax + tiny)).to(cd).mean()

    # factored eigen-residual of the updated triplet:
    #   C = U1^T (U0 diag(s0) V0^T + a b^T) V1   (O((m+n) r^2), never dense)
    core = ((u1f.mT @ u0f) * s0f[None, :]) @ (v0f.mT @ v1f) \
        + torch.outer(u1f.mT @ af, bf @ v1f)
    smax = s1f.amax() + tiny
    resid = (torch.diagonal(core) - s1f).abs().amax() / smax

    # bf16 headroom: budget minus the measured drift floor
    quant = (s1f - s1.to(u1.dtype).to(cd)).abs().amax() / smax
    headroom = _BF16_SIGMA_BUDGET - torch.maximum(quant, drift.to(cd))
    return torch.stack([drift.to(cd), defl, resid, headroom])


def probe_update(u0, s0, v0, a, b, u1, s1, v1, *,
                 deflate_rtol: float | None = None) -> HealthReport:
    """Full health sample around one applied update: ``(u0, s0, v0)`` is the
    state the pair ``(a, b)`` was applied to, ``(u1, s1, v1)`` the result.
    Runs on the factors' device and reads the four gauges to the host in one
    copy."""
    if deflate_rtol is None:
        cd = torch.float32 if u0.dtype.itemsize <= 2 else u0.dtype
        deflate_rtol = 64.0 * torch.finfo(cd).eps
    vals = _probe_update_tensors(u0, s0, v0, a, b, u1, s1, v1, float(deflate_rtol))
    return HealthReport(*(float(x) for x in vals.cpu().tolist()))


def probe_state(u, s, v) -> HealthReport:
    """Health sample from a bare state (no update pair in hand): ortho drift
    + quantization headroom; deflation/secular gauges report 0."""
    sf = _compute(s)
    vals = torch.stack([ortho_drift(u, v).to(sf.dtype), sf.amax(),
                        (sf - s.to(u.dtype).to(sf.dtype)).abs().amax()]).cpu().tolist()
    drift, smax, qabs = vals
    smax = smax or 1.0
    return HealthReport(drift, 0.0, 0.0, _BF16_SIGMA_BUDGET - max(qabs / smax, drift))


class HealthMonitor:
    """Samples health probes every N flushes and publishes gauges.

    ``every=N`` sets the cadence (``due`` is true on every Nth tick);
    ``thresholds`` maps gauge name → limit (above = bad, except
    ``bf16_headroom`` where below = bad).  A trip raises ``HealthWarning``
    via ``warnings.warn`` and bumps ``health_warnings_total{probe=...}``.
    """

    def __init__(self, *, every: int = 1, thresholds: dict | None = None,
                 registry: "_metrics.MetricsRegistry | None" = None,
                 **labels):
        if every < 1:
            raise ValueError(f"health_every must be >= 1; got {every}")
        self.every = every
        self.thresholds = dict(DEFAULT_THRESHOLDS if thresholds is None
                               else thresholds)
        self.labels = labels
        self._registry = registry
        self._ticks = 0
        self._lock = threading.Lock()
        self.last: HealthReport | None = None

    @property
    def registry(self) -> "_metrics.MetricsRegistry":
        return self._registry if self._registry is not None else _metrics.registry()

    def due(self) -> bool:
        """Advance the flush tick; True when this tick should sample."""
        with self._lock:
            self._ticks += 1
            return self._ticks % self.every == 0

    def record(self, report: HealthReport) -> HealthReport:
        """Publish one report as gauges and run the watchdog."""
        reg = self.registry
        for name, value in report._asdict().items():
            reg.gauge(f"health_{name}", **self.labels).set(value)
            limit = self.thresholds.get(name)
            if limit is None:
                continue
            bad = value <= limit if name in _LOWER_IS_BAD else value >= limit
            if bad:
                reg.counter("health_warnings_total", probe=name,
                            **self.labels).inc()
                warnings.warn(
                    f"health watchdog: {name}={value:.3e} crossed "
                    f"threshold {limit:.3e}", HealthWarning, stacklevel=3)
        self.last = report
        return report

    def sample_update(self, u0, s0, v0, a, b, u1, s1, v1, *,
                      deflate_rtol: float | None = None) -> HealthReport:
        return self.record(probe_update(u0, s0, v0, a, b, u1, s1, v1,
                                        deflate_rtol=deflate_rtol))

    def sample_state(self, u, s, v) -> HealthReport:
        return self.record(probe_state(u, s, v))
