"""``Mesh``: a named grid of devices, the port's counterpart of
``jax.sharding.Mesh`` (with ``launch.mesh.make_host_mesh``).

A mesh lives in one process, like the reference's single-controller mesh,
and needs no process group: the engine's mesh rows split a batch over one of
its axes and run each slice on that entry's device (``core.engine``), the
service spreads a round's batch the same way, and the fleet pins shards to
its devices (``fleet.placement.plan_devices``).  Cross-process work goes
through ``dist.collectives`` on a ``torch.distributed`` process group
instead.

Unlike ``jax.sharding.Mesh``, a mesh may name one device more than once: torch
has a single CPU device, and a machine with one card has one CUDA device, so a
four-entry batch axis there repeats it.  Each entry still runs its own slice,
so padding and slicing are the same as on four cards.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Mesh", "check_mesh", "make_host_mesh"]


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        from repro_torch.api.state import resolve_device

        resolve_device(dev)
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An immutable grid of ``torch.device``s with one name per axis.

    >>> m = Mesh([["cpu"], ["cpu"]], ("data", "model"))
    >>> m.shape, m.size
    ({'data': 2, 'model': 1}, 2)
    >>> m.batch_devices("data")
    (device(type='cpu'), device(type='cpu'))
    """

    __slots__ = ("_flat", "_grid", "axis_names")

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} distinct axis "
                             f"names; got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "_flat", tuple(_device(d) for d in arr.flat))
        object.__setattr__(self, "_grid", arr.shape)
        object.__setattr__(self, "axis_names", names)

    def __setattr__(self, name, value):
        raise AttributeError("Mesh is immutable")

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self._flat == other._flat
                and self._grid == other._grid and self.axis_names == other.axis_names)

    def __hash__(self):
        return hash((self._flat, self._grid, self.axis_names))

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self._flat]})"

    @property
    def devices(self) -> np.ndarray:
        """The device grid (a fresh object array, axes in ``axis_names`` order)."""
        arr = np.empty(len(self._flat), dtype=object)
        arr[:] = self._flat
        return arr.reshape(self._grid)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self._grid))

    @property
    def size(self) -> int:
        return math.prod(self._grid)

    def axis_size(self, axis: str) -> int:
        try:
            return self.shape[axis]
        except KeyError:
            raise ValueError(f"mesh has no axis {axis!r}; axes: {self.axis_names}") from None

    def batch_devices(self, axis: str) -> tuple:
        """One device per entry of ``axis``: the first along every other axis
        (a batch split over ``axis`` is replicated over the others, so their
        first device runs it)."""
        self.axis_size(axis)
        grid = self.devices
        moved = np.moveaxis(grid, self.axis_names.index(axis), 0)
        return tuple(moved.reshape(moved.shape[0], -1)[:, 0])


def check_mesh(mesh) -> "Mesh | None":
    """``mesh`` if it is a ``Mesh`` or None; anything else is refused."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"expected a repro_torch.dist.Mesh (or None); got {type(mesh).__name__}")
    return mesh


def make_host_mesh(data: int | None = None, model: int = 1, *, device="cuda") -> Mesh:
    """A ``(data, model)`` mesh over the cards of this process
    (``torch.cuda.device_count()``), or over the CPU for ``device="cpu"``.
    ``data`` defaults to the device count over ``model``; a mesh larger than
    the device count names the devices round-robin."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.api.state import resolve_device

        resolve_device(dev)
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        pool = [dev]
    if data is None:
        data = max(len(pool) // model, 1)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1; got data={data}, model={model}")
    flat = [pool[i % len(pool)] for i in range(data * model)]
    return Mesh([flat[i * model:(i + 1) * model] for i in range(data)], ("data", "model"))
