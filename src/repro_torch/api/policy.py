"""``UpdatePolicy``: every knob of a rank-1 SVD update in one frozen object.

Counterpart of ``repro.api.policy``.  ``resolve_method`` keeps the
reference's routing rule (the fused gate of ``kernels.fused_update`` with its
8 MiB budget, then the FMM floor), so that ``method="auto"`` picks the same
route in both packages for the same geometry, and ``engine_key`` returns the
reference's 8-tuple.  The gate is kept for route parity with the reference;
it is not derived from this card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.eigh_update import FMM_MIN_N

__all__ = ["UpdatePolicy", "METHODS", "FMM_MIN_N", "as_torch_dtype", "policy_from_legacy"]

# "pallas" is the public name of the Cauchy-kernel route (engine name
# "kernel"); "fast" is the reference's host-side benchmark baseline.
METHODS = ("auto", "direct", "fmm", "fast", "pallas", "kernel", "fused")

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def as_torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a name, or a numpy dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    name = getattr(dt, "name", None) or str(dt)
    name = name.rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dt!r}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class UpdatePolicy:
    """How a rank-1 update runs.

    method         auto | direct | fmm | pallas | fused (| kernel alias);
                   fast is refused (a host-side benchmark baseline)
    fmm_p          Chebyshev order of the FMM route (error ~ (3+2 sqrt 2)^-p)
    sign_fix       reconcile left/right singular-vector signs
    deflate_rtol   deflation tolerance override (None = default)
    precision      float32 matmul precision (None = "highest": no TF32)
    storage_dtype  keep factors in this dtype; 16-bit storage computes in f32
    sketch_oversample   extra range-finder samples beyond a sketch's rank
    sketch_power_iters  power iterations of the dense range-finder
    mesh           a ``dist.mesh.Mesh`` to spread a batched update over
                   (None = local)
    batch_axis     the mesh axis carrying the batch
    truncate_to    keep only the top-r triplets of every result
    health_every   sample the numerical-health probes (``repro_torch.obs``)
                   every N flush rounds of the service (None = never)

    The sketch knobs key the planner's schedule cache (``sketch_params``), not
    the engine: the rank-1 update itself does not depend on them.
    ``batch_axis`` and ``health_every`` key nothing: the probes run outside
    the update, after its launches, so the cadence cannot change a result.

    >>> pol = UpdatePolicy(method="fmm", fmm_p=12)
    >>> pol.replace(truncate_to=8).truncate_to
    8
    >>> hash(pol) == hash(UpdatePolicy(method="fmm", fmm_p=12))
    True
    >>> UpdatePolicy(method="svd")
    Traceback (most recent call last):
        ...
    ValueError: unknown method 'svd'; one of ('auto', 'direct', 'fmm', 'fast', 'pallas', 'kernel', 'fused')
    """

    method: str = "auto"
    fmm_p: int = 20
    sign_fix: bool = True
    deflate_rtol: float | None = None
    precision: str | None = None
    storage_dtype: Any = None
    sketch_oversample: int = 8
    sketch_power_iters: int = 1
    mesh: Any = None
    batch_axis: str = "data"
    truncate_to: int | None = None
    health_every: int | None = None

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; one of {METHODS}")
        if self.truncate_to is not None and self.truncate_to < 1:
            raise ValueError(f"truncate_to must be >= 1; got {self.truncate_to}")
        if self.sketch_oversample < 0:
            raise ValueError(f"sketch_oversample must be >= 0; got {self.sketch_oversample}")
        if self.sketch_power_iters < 0:
            raise ValueError(f"sketch_power_iters must be >= 0; got {self.sketch_power_iters}")
        if self.health_every is not None and self.health_every < 1:
            raise ValueError(f"health_every must be >= 1 or None; got {self.health_every}")
        if self.storage_dtype is not None:
            object.__setattr__(self, "storage_dtype", as_torch_dtype(self.storage_dtype))
        if self.mesh is not None:
            from repro_torch.dist.mesh import check_mesh

            check_mesh(self.mesh)

    def replace(self, **kw) -> "UpdatePolicy":
        return dataclasses.replace(self, **kw)

    def resolve_method(self, problem_n: int, *, m: int | None = None, n: int | None = None,
                       rank: int | None = None) -> str:
        """Concrete engine method for a problem of secular size ``problem_n``
        (``n`` for full updates, ``rank + 1`` for truncated ones).

        ``auto`` takes the fused kernels whenever enough geometry is known
        (``m``, plus ``n`` / ``rank`` where they differ from ``problem_n``)
        and it passes the reference's gate; otherwise the FMM above its
        floor, else ``direct``:

        >>> UpdatePolicy(method="fmm").resolve_method(problem_n=256)
        'fmm'
        >>> UpdatePolicy().resolve_method(problem_n=9)  # auto: below the FMM floor
        'direct'
        >>> UpdatePolicy(method="pallas").resolve_method(64)  # public kernel name
        'kernel'
        >>> UpdatePolicy().resolve_method(48, m=32)  # auto + geometry: fused
        'fused'
        """
        if self.method == "fast":
            raise NotImplementedError(
                "method='fast' (Gerasoulis FAST) is the reference's host-side benchmark "
                "baseline, not an engine route")
        if self.method == "pallas":
            return "kernel"
        if self.method == "auto":
            if m is not None:
                from repro_torch.kernels.fused_update import fused_supported

                dt = self.storage_dtype if self.storage_dtype is not None else torch.float32
                if fused_supported(m, n if n is not None else problem_n, rank, dtype=dt):
                    return "fused"
            return "fmm" if problem_n >= FMM_MIN_N else "direct"
        return self.method

    def engine_key(self, problem_n: int, *, m: int | None = None, n: int | None = None,
                   rank: int | None = None) -> tuple:
        """``(method, fmm_p, sign_fix, deflate_rtol, precision, storage_dtype,
        sketch_oversample, sketch_power_iters)``, the reference's tuple: the
        first six key ``core.engine.default_engine``, the sketch fields the
        planner's schedule cache."""
        return (self.resolve_method(problem_n, m=m, n=n, rank=rank), self.fmm_p,
                self.sign_fix, self.deflate_rtol, self.precision, self.storage_dtype,
                self.sketch_oversample, self.sketch_power_iters)

    @property
    def sketch_params(self) -> tuple[int, int]:
        """``(oversample, power_iters)``: the schedule-cache fold of the
        range-finder knobs (``updates.planner.lower``)."""
        return (self.sketch_oversample, self.sketch_power_iters)


def policy_from_legacy(policy: UpdatePolicy | None, method: str = "direct", mesh: Any = None,
                       batch_axis: str = "data") -> UpdatePolicy:
    """The policy a layer that still takes the reference's legacy ``method=``
    / ``mesh=`` / ``batch_axis=`` keywords runs under: ``policy`` when given,
    else one built from them."""
    if policy is not None:
        return policy
    return UpdatePolicy(method=method, mesh=mesh, batch_axis=batch_axis)
