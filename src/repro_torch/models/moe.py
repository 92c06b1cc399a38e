"""Mixture-of-Experts FFN: top-k router + capacity-bounded dispatch (port of ``repro.models.moe``).

Prefill ranks each (token, expert) pair within its expert's group by
one stable argsort of the flat expert ids, writes the pairs into an
(E*C + 1, D) buffer (C = ceil(T*K/E * capacity_factor); pairs past C
are dropped into the last row, the reference's dump row), runs the
expert FFNs as products batched over the experts, and gathers the rows
back weighted by their gates.  Decode gathers each token's top-k expert
weights instead (the reference's default) or, with
``flags.MOE_DECODE_DISPATCH`` and at least as many pairs as experts,
runs the dispatch too.  The expert products are plain large matrix
products, which the reference also leaves outside any Pallas kernel, so
they run as ``torch.bmm`` / ``einsum`` here.

``DROPPED`` counts the (token, expert) pairs the dispatch has dropped at
capacity since it was last set to 0 (not on the meta device, which
holds no values).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (gather, is_placed, replicated_like,
                                       shard)
from repro_torch.models import flags
from repro_torch.models.layers import (MLP, apply_mlp, dense_init_,
                                       model_dtype, param)

#: (token, expert) pairs dropped at capacity since the count was last 0
DROPPED = 0
#: the logical axis the dispatched rows of each expert are placed by
CAPACITY = "embed"


class MoE(nn.Module):
    """``router`` (d, E) fp32, ``wi``/``wg`` (E, d, f), ``wo`` (E, f, d)
    and, with shared experts, ``shared`` (an MLP of
    ``num_shared_experts * moe_d_ff``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt, d, f, E = (model_dtype(cfg), cfg.d_model, cfg.moe_d_ff,
                       cfg.num_experts)
        up = ("expert", "embed", "expert_mlp")
        self.router = param((d, E), torch.float32, device, ("embed", None))
        self.wi = param((E, d, f), dt, device, up)
        self.wg = param((E, d, f), dt, device, up)
        self.wo = param((E, f, d), dt, device,
                        ("expert", "expert_mlp", "embed"))
        if cfg.num_shared_experts:
            self.shared = MLP(cfg, device,
                              d_ff=cfg.num_shared_experts * cfg.moe_d_ff)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's scales (``in_axis=1`` of each stack), drawn
        expert by expert: one fp32 draw of a whole stack is a transient
        as large as the stack in fp32."""
        dense_init_(self.router, generator)
        for w in (self.wi, self.wg, self.wo):
            for e in range(w.shape[0]):
                dense_init_(w[e], generator)
        if "shared" in self._modules:
            self.shared.reset_parameters(generator)


def _act(h, cfg: ModelConfig):
    return F.silu(h) if cfg.act == "silu" else F.gelu(h, approximate="tanh")


def _route(params: MoE, xt, cfg: ModelConfig):
    """fp32 router softmax, top-k, gates renormalised."""
    probs = torch.softmax(xt.float() @ params.router, dim=-1)
    gates, eidx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, eidx


def apply_moe(params: MoE, x, cfg: ModelConfig, decode: bool = False):
    """x: (B, S, D) -> (y, aux_loss); decode gathers the experts' weights
    per token (no capacity, aux 0.0) unless ``flags.MOE_DECODE_DISPATCH``
    and the step holds at least as many pairs as experts.  Every shape
    follows from the config and x's, so the dispatch also runs on the
    meta device (the dry run)."""
    global DROPPED
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xt = shard(x.reshape(T, D), "batch", "embed_act")
    probs, gates, eidx = _route(params, xt, cfg)
    if decode and not (flags.MOE_DECODE_DISPATCH and T * K >= E):
        y = _gather_experts(params, xt, gates, eidx, cfg)
        if "shared" in params._modules:
            y = y + apply_mlp(params.shared, xt, cfg)
        return y.reshape(B, S, D), 0.0

    # load-balance aux loss (Switch/DeepSeek style).  Placed, the pairs'
    # bookkeeping and the dispatch and combine below run on plain tensors
    # that every device holds whole and alike (``gather``: the expert ids,
    # the token rows, the experts' outputs and the gates gathered), so
    # they need no DTensor partitioning of their scatters (torch 2.11
    # has none for ``index_add_``); each device's experts take their own
    # rows of the dispatch buffer.
    e_flat = gather(eidx).reshape(-1)                            # (T*K,)
    counts = torch.zeros(E, dtype=e_flat.dtype, device=e_flat.device)
    counts.index_add_(0, e_flat, torch.ones_like(e_flat))
    f_e = replicated_like(probs, counts.float() / (T * K))
    aux = E * torch.sum(f_e * probs.mean(0)) * cfg.router_aux_coef

    # capacity-bounded dispatch: rank within the expert's group
    C = max(1, int(math.ceil(T * K / E * cfg.capacity_factor)))
    order = torch.argsort(e_flat, stable=True)
    group_start = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(e_flat)
    pos[order] = (torch.arange(T * K, device=e_flat.device)
                  - group_start[e_flat[order]])
    keep = pos < C
    if not keep.is_meta:          # a meta tensor holds no values to count
        DROPPED += T * K - int(keep.sum())
    # kept pairs have distinct rows; dropped ones all land on the dump
    # row E*C, which no expert reads (a copy, no accumulation)
    dest = torch.where(keep, e_flat * C + pos, E * C)
    rows_in = gather(xt)
    buf = rows_in.new_zeros((E * C + 1, D))
    buf[dest] = rows_in.repeat_interleave(K, dim=0)
    # the reference's constraints name the rows "capacity", which no rule
    # maps; GSPMD then splits each expert's rows over the axis the expert
    # weights are split on besides "expert" (the train rules' FSDP
    # "embed"), so the rows go there (``CAPACITY``)
    eb = shard(replicated_like(xt, buf[:E * C].view(E, C, D)), "expert",
               CAPACITY, "embed_act")
    eo = shard(_expert_products(params, eb, cfg), "expert", CAPACITY,
               "embed_act")

    # combine: each kept pair's row weighted by its gate, summed over K
    rows = gather(eo).reshape(E * C, D)[torch.where(keep, dest, 0)]
    rows = torch.where(keep[:, None], rows, 0)
    rows = rows * gather(gates).reshape(-1, 1).to(rows.dtype)
    y = replicated_like(xt, rows.view(T, K, D).sum(1))
    if "shared" in params._modules:
        y = y + apply_mlp(params.shared, xt, cfg)
    return y.reshape(B, S, D), aux


def _expert_products(params: MoE, eb, cfg: ModelConfig):
    """eb: (E, C, D) dispatched rows -> (E, C, D), batched over experts."""
    h = torch.bmm(eb, params.wi)
    if cfg.act in ("silu", "geglu"):
        h = _act(torch.bmm(eb, params.wg), cfg) * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = shard(h, "expert", CAPACITY, "expert_mlp")
    return torch.bmm(h, params.wo)


def _gathered(w, eidx):
    """w[eidx]: each token's experts' weights, (T, K, ...).  Placed over
    its experts, each device takes the rows of its own experts (a masked
    lookup, DTensor's partial sum) and the rows are then summed over the
    devices: GSPMD's gather from a split operand, an all-reduce of the
    gathered weights."""
    if not is_placed(w):
        return w[eidx]
    E = w.shape[0]
    rows = F.embedding(eidx, w.reshape(E, -1))
    rows = shard(rows, "batch", None, None)
    return rows.view(*eidx.shape, *w.shape[1:])


def _gather_experts(params: MoE, xt, gates, eidx, cfg: ModelConfig):
    """Per-token expert weight gather (decode).  xt: (T, D); the gathered
    stacks are (T, K, d, f) per weight, as in the reference."""
    T, K = eidx.shape
    xk = xt[:, None, None, :].expand(T, K, 1, xt.shape[1])
    h = (xk @ _gathered(params.wi, eidx))[:, :, 0]              # (T, K, f)
    if cfg.act in ("silu", "geglu"):
        h = _act((xk @ _gathered(params.wg, eidx))[:, :, 0], cfg) * h
    else:
        h = F.gelu(h, approximate="tanh")
    out = (h[:, :, None, :] @ _gathered(params.wo, eidx))[:, :, 0]  # (T,K,d)
    return torch.einsum("tkd,tk->td", out, gates.to(out.dtype))
