"""Carry the reference's weights into the port.

``params_from_reference(cfg, tree)`` takes the reference's parameter tree
as plain arrays (``unbox(repro.models.model.init(cfg, key))``, converted
leaf by leaf with ``np.asarray``), whose layer leaves (``dense_layers``,
``moe_layers``, the SSM ``layers``, the encoder-decoder's ``enc_layers``
and ``dec_layers``) are stacked along a leading axis as long as the
stack, and returns the port's model (``model.module(cfg)``) holding the
same values: leaf ``layers.mixer.in_proj[i]`` becomes parameter
``layers.{i}.mixer.in_proj``.  Unstacked leaves, such as the hybrid's
``shared_attn`` or the encoder's ``enc_pos`` and ``enc_norm``, keep
their names.
Every leaf must map onto exactly one parameter of the same shape, and
every parameter must be covered.

``params_to_reference(cfg, lm)`` is the inverse: the reference's nested
tree of numpy arrays (fp32 for bf16 parameters, whose values widen
exactly), layer leaves stacked again along their leading axis.  Passed
the parameters' ``.grad`` instead (``grads=True``), it carries the
gradients across under the same mapping.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod

#: reference subtrees whose leaves are stacked over their layers
STACKED = ("dense_layers.", "moe_layers.", "enc_layers.", "dec_layers.",
           "layers.")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _tensor(x) -> torch.Tensor:
    # bf16 leaves arrive as ml_dtypes.bfloat16 arrays, which torch cannot
    # take directly; widening to fp32 first makes the bf16 round trip exact.
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


@torch.no_grad()
def params_from_reference(cfg: ModelConfig, tree: Mapping,
                          device: DeviceLike = None) -> nn.Module:
    """The port's model with the reference tree's values, on ``device``."""
    lm = model_mod.module(cfg, resolve_device(device))
    params = dict(lm.named_parameters())
    assigned = set()
    for name, leaf in _flatten(tree).items():
        src = _tensor(leaf)
        stack = next((s for s in STACKED if name.startswith(s)), None)
        if stack is not None:
            rest = name[len(stack):]
            depth = len(getattr(lm, stack[:-1], ()))
            if src.shape[0] != depth:
                raise ValueError(f"{name}: leading axis {src.shape[0]} is "
                                 f"not the port's {depth} {stack[:-1]}")
            targets = [(f"{stack}{i}.{rest}", src[i]) for i in range(depth)]
        else:
            targets = [(name, src)]
        for tname, value in targets:
            dst = params.get(tname)
            if dst is None:
                raise KeyError(f"reference leaf {name!r} has no counterpart "
                               f"{tname!r} in the port")
            if tuple(dst.shape) != tuple(value.shape):
                raise ValueError(f"{tname}: port shape {tuple(dst.shape)}, "
                                 f"reference {tuple(value.shape)}")
            dst.copy_(value.to(dst.dtype))
            assigned.add(tname)
    missing = sorted(set(params) - assigned)
    if missing:
        raise KeyError(f"port parameters with no reference leaf: {missing}")
    return lm


def _stack_of(name: str):
    """(stack prefix, layer index, rest) of a port parameter name in a
    stacked subtree, or None."""
    for stack in STACKED:
        if name.startswith(stack):
            idx, rest = name[len(stack):].split(".", 1)
            return stack, int(idx), rest
    return None


def reference_groups(lm: nn.Module) -> Dict[str, Tuple[bool, List]]:
    """The port's parameters under the reference tree's dotted keys
    (``layers.mixer.in_proj``): ``(True, [(name, parameter), ...])`` with
    a stack's layers in order for a leaf the reference stacks over its
    layers, ``(False, [(name, parameter)])`` for any other; unstacked
    leaves first, in the module's order."""
    groups: Dict[str, Tuple[bool, List]] = {}
    stacked: Dict[str, Dict[int, Tuple[str, nn.Parameter]]] = {}
    for name, p in lm.named_parameters():
        where = _stack_of(name)
        if where is None:
            groups[name] = (False, [(name, p)])
        else:
            stack, i, rest = where
            stacked.setdefault(stack + rest, {})[i] = (name, p)
    for key, layers in stacked.items():
        groups[key] = (True, [layers[i] for i in range(len(layers))])
    return groups


def reference_leaves(lm: nn.Module,
                     grads: bool = False) -> Dict[str, np.ndarray]:
    """The reference tree's leaves by dotted key path (``layers.mixer.
    in_proj``), layer leaves stacked, as fp32 (bf16 widens exactly) or
    native numpy arrays: ``lm``'s values, or its parameters' gradients
    (``grads``; raises when one is missing)."""
    flat: Dict[str, np.ndarray] = {}
    for key, (stacked, named) in reference_groups(lm).items():
        arrs = []
        for name, p in named:
            t = p.grad if grads else p
            if t is None:
                raise ValueError(f"{name}: no gradient")
            # reprolint: disable=R8 -- a host copy of the model is the point (checkpoints, tests): each leaf crosses once, with no device-side staging buffer
            arrs.append(t.detach().float().cpu().numpy())
        flat[key] = np.stack(arrs) if stacked else arrs[0]
    return flat


def params_to_reference(cfg: ModelConfig, lm: nn.Module,
                        grads: bool = False) -> Dict[str, object]:
    """The reference's parameter tree (nested dicts of numpy arrays) with
    ``lm``'s values, or with its parameters' gradients (``grads``); bf16
    leaves come back as fp32.  ``lm`` must be ``cfg``'s model: the same
    parameter names and shapes."""
    want = {n: tuple(p.shape) for n, p in
            model_mod.module(cfg, torch.device("meta")).named_parameters()}
    have = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))
        raise ValueError(f"the model is not {cfg.name}'s: {diff[:4]}")
    tree: Dict[str, object] = {}
    for key, arr in reference_leaves(lm, grads).items():
        node = tree
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree
