"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module must never
touch CUDA state or process-group state.  A :class:`Mesh` is a
description (its axis names, the size of each axis and, for a mesh of
real cards, their torch devices) and, when a process group spans it, a
``torch.distributed`` ``DeviceMesh`` of the same shape and axis names,
over which ``dist.sharding`` places tensors as DTensors.

- :func:`make_local_mesh` is (world, 1) over the launched ranks' cards
  (``torchrun``), as the reference's is (n, 1) over its devices; with
  no process group, the one card at (1, 1) and no ``DeviceMesh``.
- :func:`make_production_mesh` is 16x16 or 2x16x16; it carries a
  ``DeviceMesh`` inside :func:`fake_group` of its size, where the dry
  run places a case on meta tensors and counts what one device does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]            # axis -> size, in axis_names order
    devices: Tuple[torch.device, ...] = ()
    device_mesh: Optional[DeviceMesh] = None

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.shape.values())


def make_mesh(sizes: Tuple[int, ...], axes: Tuple[str, ...], devices=(),
              device_type: str = "cuda") -> Mesh:
    """A mesh of ``sizes`` over ``axes``, with a ``DeviceMesh`` of
    ``device_type`` when the default process group has exactly as many
    ranks as the mesh has devices."""
    device_mesh = None
    if dist.is_initialized() and dist.get_world_size() == math.prod(sizes):
        device_mesh = init_device_mesh(device_type, sizes,
                                       mesh_dim_names=axes)
    return Mesh(axis_names=axes, shape=dict(zip(axes, sizes)),
                devices=tuple(devices), device_mesh=device_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; multi_pod adds a 2-pod axis.  No
    devices; a ``DeviceMesh`` inside a :func:`fake_group` of 256 (512)
    ranks, for the dry run's per-device accounting."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_local_mesh() -> Mesh:
    """(world, 1) over ("data", "model"): one rank per card when a
    process group is up (``torchrun``; gloo on CPU ranks), the rank's
    own card in ``devices``; otherwise the visible CUDA devices at
    (n, 1), (1, 1) on one card and on a host without one."""
    if dist.is_initialized():
        cuda = dist.get_backend() == "nccl"
        devices = ((torch.device("cuda", torch.cuda.current_device()),)
                   if cuda else ())
        return make_mesh((dist.get_world_size(), 1), ("data", "model"),
                     devices, device_type="cuda" if cuda else "cpu")
    n = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(n)]
    return make_mesh((max(n, 1), 1), ("data", "model"), devices)


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of ``world`` ranks, this process rank 0, whose
    collectives move nothing (backend ``"fake"``): DTensor places meta
    tensors over a mesh of that size in one process.  Closed on exit;
    raises if a process group is already up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
