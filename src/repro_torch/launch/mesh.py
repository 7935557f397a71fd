"""Production meshes (twin of ``repro.launch.mesh``).

The reference builds its production meshes from 256 or 512 placeholder
host devices.  Those devices do not exist here, and a torch ``DeviceMesh``
needs one process a device, so the port's production mesh is abstract: its
axis names and sizes only, which is all that ``distributed.sharding`` and
the dry run read.  No ``DeviceMesh`` is built and no process group is
joined.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: 256 or 512 devices, abstract."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def mesh_chips(mesh) -> int:
    """Devices of a mesh (an ``AbstractMesh``, a ``shape`` mapping's mesh,
    or a torch ``DeviceMesh``)."""
    from repro_torch.distributed.sharding import mesh_axes
    return math.prod(mesh_axes(mesh)[1].values())
