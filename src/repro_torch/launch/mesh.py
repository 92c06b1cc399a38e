"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module must never
touch CUDA state.  A :class:`Mesh` is a description: its axis names, the
size of each axis and, for a mesh of real cards, their torch devices.
The port places nothing across cards (``dist.sharding.shard`` raises on
a mesh of more than one device); the dry run reads a production mesh's
axis sizes for its per-device accounting.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]            # axis -> size, in axis_names order
    devices: Tuple[torch.device, ...] = ()

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.shape.values())


def _mesh(sizes: Tuple[int, ...], axes: Tuple[str, ...], devices=()) -> Mesh:
    return Mesh(axis_names=axes, shape=dict(zip(axes, sizes)),
                devices=tuple(devices))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; multi_pod adds a 2-pod axis.  No
    devices: a description for the dry run's per-device accounting."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_local_mesh() -> Mesh:
    """(n, 1) over ("data", "model") across the visible CUDA devices: (1, 1)
    on one card, and on a host without one."""
    n = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(n)]
    return _mesh((max(n, 1), 1), ("data", "model"), devices)
