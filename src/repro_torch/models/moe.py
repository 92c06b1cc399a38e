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
they run as ``torch.bmm`` / ``einsum`` here.  Placed, each device
dispatches and combines only its own tokens' pairs, and rows reach the
devices of their experts by sums over the mesh (``_split_dispatch``).

``DROPPED`` counts the (token, expert) pairs the dispatch has dropped at
capacity since it was last set to 0 (not on the meta device, which
holds no values).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (constraint, from_pieces, is_placed,
                                       replicated_like, row_axes, row_pieces,
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

    # capacity-bounded dispatch: rank within the expert's group
    C = max(1, int(math.ceil(T * K / E * cfg.capacity_factor)))
    dispatch = _split_dispatch if is_placed(xt) else _dispatch
    y, aux = dispatch(params, xt, probs, gates, eidx, C, cfg)
    if "shared" in params._modules:
        y = y + apply_mlp(params.shared, xt, cfg)
    return y.reshape(B, S, D), aux


def expert_counts(e_flat, E: int):
    """(E,) pairs routed to each expert."""
    counts = torch.zeros(E, dtype=e_flat.dtype, device=e_flat.device)
    return counts.index_add_(0, e_flat, torch.ones_like(e_flat))


def group_ranks(e_flat, counts):
    """Each pair's rank among the pairs of its expert, in e_flat's order
    (one stable argsort)."""
    order = torch.argsort(e_flat, stable=True)
    group_start = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(e_flat)
    pos[order] = (torch.arange(e_flat.numel(), device=e_flat.device)
                  - group_start[e_flat[order]])
    return pos


def piece_ranks(e_piece, every, r: int):
    """The global ranks (``group_ranks`` of every piece's pairs laid end
    to end) of the pairs of piece ``r`` of contiguous pieces, from each
    piece's counts alone: ``every`` (pieces, E), ``every[r]`` its own.
    A pair's rank is its expert's pairs on the earlier pieces plus its
    rank within its own piece."""
    return group_ranks(e_piece, every[r]) + every[:r].sum(0)[e_piece]


def _aux_loss(probs, counts, pairs: int, cfg: ModelConfig):
    """Load-balance aux loss (Switch/DeepSeek style); ``counts``: every
    expert's pairs over the whole step."""
    f_e = replicated_like(probs, counts.float() / pairs)
    return cfg.num_experts * torch.sum(f_e * probs.mean(0)) \
        * cfg.router_aux_coef


def _experts(params: MoE, eb, cfg: ModelConfig):
    """(E, C, D) dispatched rows -> the experts' outputs, placed by the
    reference's constraints.  The reference names the rows "capacity",
    which no rule maps; GSPMD then splits each expert's rows over the
    axis the expert weights are split on besides "expert" (the train
    rules' FSDP "embed"), so the rows go there (``CAPACITY``)."""
    eb = shard(eb, "expert", CAPACITY, "embed_act")
    return shard(_expert_products(params, eb, cfg), "expert", CAPACITY,
                 "embed_act")


def _combine(rows, keep, gates, K: int):
    """Each pair's output row weighted by its gate (0 where dropped),
    summed over the token's K pairs in order."""
    rows = torch.where(keep[:, None], rows, 0)
    rows = rows * gates.reshape(-1, 1).to(rows.dtype)
    return rows.view(-1, K, rows.shape[-1]).sum(1)


def _dispatch(params: MoE, xt, probs, gates, eidx, C: int,
              cfg: ModelConfig):
    """The unplaced dispatch: every pair into an (E*C + 1, D) buffer."""
    global DROPPED
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    e_flat = eidx.reshape(-1)                                    # (T*K,)
    counts = expert_counts(e_flat, E)
    aux = _aux_loss(probs, counts, T * K, cfg)
    pos = group_ranks(e_flat, counts)
    keep = pos < C
    if not keep.is_meta:          # a meta tensor holds no values to count
        DROPPED += T * K - int(keep.sum())
    # kept pairs have distinct rows; dropped ones all land on the dump
    # row E*C, which no expert reads (a copy, no accumulation)
    dest = torch.where(keep, e_flat * C + pos, E * C)
    buf = xt.new_zeros((E * C + 1, D))
    buf[dest] = xt.repeat_interleave(K, dim=0)
    eo = _experts(params, buf[:E * C].view(E, C, D), cfg)
    rows = eo.reshape(E * C, D)[torch.where(keep, dest, 0)]
    return _combine(rows, keep, gates, K), aux


def _split_dispatch(params: MoE, xt, probs, gates, eidx, C: int,
                    cfg: ModelConfig):
    """The placed dispatch, split as GSPMD splits the reference's scatter.

    Each device ranks, dispatches and combines its own tokens' pairs
    (its rows of xt) on plain local tensors: a pair's global rank is the
    count of its expert's pairs on the earlier pieces of the token split
    (each piece's E counts all-gathered) plus its stable rank in its own
    piece, which is the reference's global stable argsort, pair for
    pair.  A device writes its kept pairs of its own experts (the split
    of the experts' axis) into a zero buffer of its experts' E_l*C rows,
    and the buffer is summed over the token axes into the placement the
    expert products take (a reduce-scatter, or an all-reduce where the
    rows are not split there): each (expert, slot) has one writer, so
    the sum is a copy.  Back, the outputs of its experts are gathered
    over the capacity axes, each device looks up its own pairs' rows and
    the rows are summed over the expert axes (an all-reduce; again one
    writer a row), so each token's K rows reach its device whole and are
    weighted and summed in the unplaced order.  No split size depends on
    values.  Raises where the experts are split over an axis that also
    splits the tokens (that takes an exchange of rows between them)."""
    global DROPPED
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    mesh = xt.device_mesh
    tok = row_axes(xt, "moe dispatch")
    want = constraint("expert", CAPACITY, "embed_act")
    if any(want[i] == Shard(0) for i in tok):
        raise ValueError(f"moe dispatch: the experts' placement {want} "
                         f"splits them over an axis that splits the "
                         f"tokens {tuple(xt.placements)}")
    experts = [Shard(0) if p == Shard(0) else Replicate() for p in want]
    split = [i for i, p in enumerate(experts) if p == Shard(0)]

    def pieces(term):
        # over each mesh axis: the tokens' split, else the experts'
        # split with ``term`` over it, else replicated
        return [Shard(0) if i in tok else term if i in split
                else Replicate() for i in range(mesh.ndim)]

    e_loc = eidx.redistribute(mesh, xt.placements).to_local().reshape(-1)
    g_loc = gates.redistribute(mesh, xt.placements).to_local()
    every, r = row_pieces(expert_counts(e_loc, E), xt, "moe dispatch")
    total = every.sum(0)
    aux = _aux_loss(probs, total, T * K, cfg)
    pos = piece_ranks(e_loc, every, r)
    keep = pos < C
    if not keep.is_meta:
        DROPPED += int((total - C).clamp_min(0).sum())

    # this device's experts: e0 .. e0 + El - 1
    (El, _, _), (e0, _, _) = compute_local_shape_and_global_offset(
        (E, C, D), mesh, experts)
    mine = keep & (e_loc >= e0) & (e_loc < e0 + El)
    slot = (e_loc - e0) * C + pos
    x_loc = xt.to_local(grad_placements=pieces(Partial()))
    buf = x_loc.new_zeros((El * C + 1, D))
    buf[torch.where(mine, slot, El * C)] = x_loc.repeat_interleave(K, 0)
    term = [Partial() if i in tok else p for i, p in enumerate(experts)]
    eb = from_pieces(buf[:El * C].view(El, C, D), mesh, term, (E, C, D))
    eo = _experts(params, eb, cfg)

    eo_loc = eo.redistribute(mesh, experts).to_local(grad_placements=term)
    rows = eo_loc.reshape(El * C, D)[torch.where(mine, slot, 0)]
    rows = torch.where(mine[:, None], rows, 0)
    rows = from_pieces(rows.view(-1, K, D), mesh, pieces(Partial()),
                       (T, K, D))
    rows = rows.redistribute(mesh, xt.placements).to_local()
    y = _combine(rows.view(-1, D), keep, g_loc, K)
    return from_pieces(y, mesh, xt.placements, (T, D)), aux


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
