"""The benchmark's weights: drawn from the seed on the device, in the
type they are served in, in two large calls (one buffer in the model
dtype, one in float32), then viewed leaf by leaf and scaled in place.

The leaves are named and shaped by the model's family module
(``bench/families/<family>.py``, ``leaves(m)``) from the configuration
file's ``model`` section alone, in the layout the port's parameter tree
has (weights ``(in, out)``, applied as ``x @ w``).  :func:`load` hands them
to the port's module and raises if the port's tree differs.  The plain
references read the same dictionary; the check draws it again from the
seed after the program is freed, so the reference takes nothing that
the program held.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.harness.shapes import padded_vocab

Leaf = Tuple[str, Tuple[int, ...], str, str]   # name, shape, dtype, init


def norm(prefix: str, d: int, layernorm: bool) -> List[Leaf]:
    """A norm's scale, and its shift for a LayerNorm."""
    out = [(f"{prefix}.scale", (d,), "float32", "scale")]
    if layernorm:
        out.append((f"{prefix}.bias", (d,), "float32", "shift"))
    return out


def embedding(m: Dict) -> List[Leaf]:
    """The token embedding, the untied head over the padded vocabulary and
    the final norm: what a decoder with an untied head draws first."""
    d, V, dt = m["d_model"], padded_vocab(m), m["dtype"]
    return [("embed.tok", (V, d), dt, "embed"),
            ("embed.head", (d, V), dt, "dense")] \
        + norm("final_norm", d, m["norm"] == "layernorm")


@torch.no_grad()
def _init(w: torch.Tensor, shape, kind: str) -> None:
    """Turn standard normal draws ``w`` into the leaf's values in place."""
    if kind == "dense":
        w.mul_(1.0 / math.sqrt(shape[0]))
    elif kind == "embed":
        w.mul_(1.0 / math.sqrt(shape[1]))
    elif kind == "scale":
        w.mul_(0.1).add_(1.0)
    elif kind in ("shift", "bias"):
        w.mul_(0.1)
    elif kind == "conv":
        w.mul_(0.2)
    elif kind == "a_log":
        w.copy_(torch.log(torch.arange(1, w.numel() + 1, dtype=w.dtype,
                                       device=w.device)))
    elif kind == "dt_bias":   # dt log-uniform in [1e-3, 0.1], inverse softplus
        u = torch.special.ndtr(w)
        dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
        w.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(kind)


@torch.no_grad()
def make(spec: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of the leaves ``spec`` (a family's ``leaves(m)``) from
    ``seed``: one normal draw per dtype over a flat buffer on ``device``,
    then each leaf a view of it, in the order of ``spec``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({s[2] for s in spec}):
        mine = [s for s in spec if s[2] == dtype]
        total = sum(math.prod(s[1]) for s in mine)
        flat = torch.empty(total, dtype=getattr(torch, dtype), device=device)
        flat.normal_(generator=gen)
        at = 0
        for name, shape, _, kind in mine:
            n = math.prod(shape)
            w = flat[at:at + n].view(shape)
            _init(w, shape, kind)
            out[name] = w
            at += n
    return {name: out[name] for name, *_ in spec}


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Put ``weights`` into the port's ``module`` (built on the meta
    device) without a copy; raise if its leaves' names, shapes or dtypes
    are not the benchmark's."""
    want = {n: (tuple(w.shape), w.dtype) for n, w in weights.items()}
    have = {n: (tuple(p.shape), p.dtype)
            for n, p in module.named_parameters()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the port's parameters differ from the "
                         f"benchmark's leaves: {diff}")
    module.load_state_dict(weights, strict=True, assign=True)
