"""Production mesh construction, in PyTorch.

Counterpart of ``repro.launch.mesh``.  ``make_production_mesh`` is a
function, so importing this module touches no device; its entries are
``torch.device("meta")``, so building it touches no card either: it is the
mesh the dry-run (``launch.dryrun``) reckons per-device figures over.
``make_host_mesh`` is ``dist.mesh.make_host_mesh``, a mesh over the cards of
this process (or the CPU, for ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.mesh import Mesh, make_host_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 entries a pod; ``multi_pod`` adds a leading ``pod=2``
    axis (512), every entry the meta device.

    >>> make_production_mesh(multi_pod=True).shape
    {'pod': 2, 'data': 16, 'model': 16}
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(shape, dtype=object)
    grid.fill(torch.device("meta"))
    return Mesh(grid, axes)
