"""Logical-axis sharding rules (port of ``repro.dist.sharding``).

Every parameter records the logical axis names of its dimensions
(``embed``, ``mlp``, ``heads``, ...) as ``logical_axes`` when its module
builds it (``models.layers.param``), with the tuple the reference boxes
its leaf with.  :func:`axes_of` and :func:`unbox` give them, and the
tensors, under the reference tree's dotted keys
(``models.convert.reference_groups``), a leaf stacked over its layers
with the reference's leading layer axis (``None``, as ``stack_init``
prepends it).

``ShardingRules`` maps logical axes to mesh axes; ``spec`` resolves an
axes tuple to a :class:`PartitionSpec`, dropping mesh axes absent from
the mesh (e.g. ``pod`` on a single-pod run) and deduplicating mesh axes
that an earlier dimension already consumed (GSPMD allows each mesh axis
at most once per spec).  :func:`local_shape` is the per-device shard of
a shape under a spec, rounded up as GSPMD pads an uneven split.

``shard(x, *axes)`` is a no-op outside an ``axis_rules(mesh, rules)``
context; inside one, on a mesh of one device, it checks that ``axes``
names every dimension of ``x`` and returns it.  Placement across cards
is not ported: on a larger mesh it raises.

Not carried: the reference's ``P`` boxes and ``box_like`` re-box
plain arrays into pytrees; the port's parameters carry their axes
themselves, so there is nothing to box.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from repro_torch.models.convert import reference_groups

Axis = Optional[str]
MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), a mesh axis, or a
    tuple of mesh axes (as ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)}"


def axes_of(module: nn.Module) -> Dict[str, Tuple[Axis, ...]]:
    """{reference key: the leaf's logical axes}; a stacked leaf's start
    with the layer axis None.  Raises if a stack's layers disagree."""
    out = {}
    for key, (stacked, named) in reference_groups(module).items():
        distinct = {p.logical_axes for _, p in named}
        if len(distinct) != 1:
            raise ValueError(f"{key}: its layers' axes differ: {distinct}")
        (ax,) = distinct
        out[key] = ((None,) + ax) if stacked else ax
    return out


def unbox(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{reference key: tensor}, a stacked leaf's layers stacked along a
    new leading axis (a copy; on the meta device, shapes only)."""
    return {key: torch.stack([p for _, p in named]) if stacked
            else named[0][1]
            for key, (stacked, named) in reference_groups(module).items()}


class ShardingRules(dict):
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""

    def spec(self, axes: Sequence[Axis], mesh=None) -> PartitionSpec:
        mesh_axes = set(mesh.axis_names) if mesh is not None else None
        used = set()
        entries = []
        for ax in axes:
            mapped = self.get(ax) if ax is not None else None
            if mapped is None:
                entries.append(None)
                continue
            cand = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            keep = [c for c in cand
                    if (mesh_axes is None or c in mesh_axes)
                    and c not in used]
            used.update(keep)
            if not keep:
                entries.append(None)
            elif len(keep) == 1:
                entries.append(keep[0])
            else:
                entries.append(tuple(keep))
        return PartitionSpec(*entries)


# Batch prefers (pod, data); params FSDP-shard embed over data and tensor-
# shard the wide dims over model.  Axes not listed stay replicated.
TRAIN_RULES = ShardingRules({
    "batch": ("pod", "data"),
    "embed": "data",
    "mlp": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "expert": "model",
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
})

# Serving replicates small params, tensor-shards wide dims, and data-
# parallelizes the batch.
SERVE_RULES = ShardingRules({
    "batch": "data",
    "mlp": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "expert": "model",
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
})

# Long-context decode: context-parallel KV over data (callers override
# batch/kv_seq per shape; see launch/dryrun.rules_for).
LONG_CTX_RULES = ShardingRules({**SERVE_RULES, "batch": None,
                                "kv_seq": "data"})


def named_sharding_tree(axes: Dict[str, Tuple[Axis, ...]], mesh,
                        rules: ShardingRules) -> Dict[str, PartitionSpec]:
    """{key: the spec ``rules`` give its axes on ``mesh``}."""
    return {key: rules.spec(ax, mesh) for key, ax in axes.items()}


def local_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """The per-device shard of a ``shape`` tensor placed by ``spec`` on
    ``mesh``: each dimension divided by the sizes of its mesh axes,
    rounded up (GSPMD pads an uneven split)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        out.append(-(-dim // math.prod(mesh.shape[a] for a in names)))
    return tuple(out)


_ctx = threading.local()


@contextlib.contextmanager
def axis_rules(mesh, rules: ShardingRules):
    """Activate ``shard``'s checks for ``mesh`` in this thread."""
    prev = getattr(_ctx, "active", None)
    _ctx.active = (mesh, rules)
    try:
        yield
    finally:
        _ctx.active = prev


def shard(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """``x``, whose dimensions ``axes`` names; no-op without an active
    ``axis_rules`` context.  Inside one, raises unless ``axes`` names
    every dimension, and on a mesh of more than one device, where the
    reference would constrain ``x``'s placement."""
    active = getattr(_ctx, "active", None)
    if active is None:
        return x
    mesh, _ = active
    if mesh.size > 1:
        raise NotImplementedError(
            f"placement across {mesh.size} devices is not ported; shard "
            f"runs on a mesh of one device only")
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} do not name the {x.ndim} dimensions "
                         f"of a {tuple(x.shape)} tensor")
    return x
