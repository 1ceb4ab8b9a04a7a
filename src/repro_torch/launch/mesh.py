"""Production meshes (port of ``repro.launch.mesh``).

A ``Mesh`` here is shape and axis names only: the dry run reckons
per-device shapes and bytes on it and runs on no device. No process group
is made; a ``DeviceMesh`` over real cards is ROADMAP.md Queue 1 item 15b's
work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence, Tuple

from ..models.layers import MeshAxes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named device axes: ``shape[i]`` devices along ``axis_names[i]``."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, entry: Any) -> int:
        """Devices along one spec entry: None, an axis name, or a tuple of
        names. Raises ValueError on a name the mesh does not have."""
        if entry is None:
            return 1
        names = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for name in names:
            if name not in self.axis_names:
                raise ValueError(f"axis {name!r} is not on the mesh "
                                 f"{self.axis_names}")
            n *= self.shape[self.axis_names.index(name)]
        return n

    def shard_shape(self, global_shape: Sequence[int], spec: Tuple
                    ) -> Tuple[int, ...]:
        """One device's block of a ``global_shape`` array laid out by
        ``spec`` (``NamedSharding(mesh, spec).shard_shape``). A dim that
        does not divide takes the ceiling, as GSPMD pads it."""
        if len(spec) > len(global_shape):
            raise ValueError(f"spec {spec} has more entries than the shape "
                             f"{tuple(global_shape)} has dims")
        entries = tuple(spec) + (None,) * (len(global_shape) - len(spec))
        return tuple(-(-d // self.axis_size(e))
                     for d, e in zip(global_shape, entries))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16×16 = 256 devices (data, model). Multi-pod: 2×16×16 =
    512 devices (pod, data, model); the pod axis carries cross-pod data
    parallelism."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def mesh_axes(multi_pod: bool = False) -> MeshAxes:
    """Placeholder-axis resolution for this mesh
    (``models/layers.resolve_spec``)."""
    return MeshAxes(fsdp=("pod", "data") if multi_pod else ("data",),
                    tp="model")


def make_host_mesh() -> Mesh:
    """Degenerate 1×1 mesh: one device, the same axis names as the single
    pod's."""
    return Mesh((1, 1), ("data", "model"))
