"""Checkpointing: a model's parameters <-> npz (port of ``repro.train.checkpoint``).

Files are the reference's: one array per leaf of the reference's
parameter tree, keyed by its key path (``k:<name>||k:<name>...``, the
``jax.tree_util`` path of a nested dict), layer leaves stacked along
their leading axis, bf16 stored as fp32 (npz has no bf16; the restore
casts back, exactly), and the step, when given, under ``__step__``.  A
file saved by either package restores in the other.  A placed model's
leaves are gathered whole to save (every rank joins; rank 0 writes) and
placed again as they restore (each rank keeps its shard).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch import nn

from repro_torch.models.convert import _stack_of, reference_leaves

_SEP = "||"


def _key(dotted: str) -> str:
    return _SEP.join(f"k:{part}" for part in dotted.split("."))


def save(path: str, params: nn.Module, step: Optional[int] = None) -> None:
    flat = {_key(name): arr
            for name, arr in reference_leaves(params).items()}
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)


def restore(path: str, like: nn.Module) -> Tuple[nn.Module, Optional[int]]:
    """Read the checkpoint into ``like``'s parameters, in place and in
    their dtypes (every parameter must have its key); returns (like,
    step or None)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    step = int(data["__step__"]) if "__step__" in data else None
    leaves: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        for name, p in like.named_parameters():
            where = _stack_of(name)
            dotted = name if where is None else where[0] + where[2]
            key = _key(dotted)
            if key not in leaves:
                if key not in data:
                    raise KeyError(f"checkpoint missing {key}")
                leaves[key] = data[key]
            arr = leaves[key] if where is None else leaves[key][where[1]]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                                 f"parameter {tuple(p.shape)}")
            src = torch.from_numpy(np.asarray(arr, np.float32))
            if isinstance(p.data, DTensor):
                src = distribute_tensor(src.to(p.to_local().device, p.dtype),
                                        p.device_mesh, p.placements,
                                        src_data_rank=None)
            p.copy_(src)
    return like, step
