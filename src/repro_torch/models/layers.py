"""Common layers: norms, RoPE, MLPs, embeddings (port of ``repro.models.layers``).

Each parameter container is an ``nn.Module`` whose attribute names are
the reference's param-tree keys (``scale``/``bias``, ``wi``/``wg``/``wo``,
``tok``/``head``/``pos``), with the reference's shapes: weights are
(in, out) and applied as ``x @ w``.  The ``apply_*`` functions are plain
functions on tensors, as in the reference.  Parameters are built
frozen (``requires_grad`` False), so serving builds no graph; training
(``train.loop``) unfreezes them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import reduced_grad, shard


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param(shape, dtype, device, axes, table: bool = False) -> nn.Parameter:
    """An uninitialised, frozen parameter (filled by ``init`` or convert)
    that records the logical axis of each of its dimensions as
    ``logical_axes``: the tuple the reference boxes the leaf with
    (``P(value, axes)``), read by ``dist.sharding.axes_of``; ``table``
    marks a table only read by rows (position embeddings), which
    placement does not gather on use (``dist.sharding.distribute``)."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not name the {len(shape)} "
                         f"dimensions of {tuple(shape)}")
    p = nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                     requires_grad=False)
    p.logical_axes = tuple(axes)
    p.table = table
    return p


@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator,
                in_axis: int = 0) -> None:
    """normal * 1/sqrt(fan_in), drawn in fp32 and cast (``dense_init``)."""
    scale = 1.0 / math.sqrt(max(w.shape[in_axis], 1))
    x = torch.randn(w.shape, generator=generator, device=w.device,
                    dtype=torch.float32)
    w.copy_(x.mul_(scale))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

class Norm(nn.Module):
    """``scale`` (fp32) and, for layernorm, ``bias`` (fp32), ``width``
    wide (``d_model`` unless given: MLA's ``q_norm``/``kv_norm`` are
    the LoRA ranks wide, have no bias and no named axis)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 width: Optional[int] = None,
                 with_bias: Optional[bool] = None):
        super().__init__()
        axes = (None,) if width else ("embed_act",)
        width = width or cfg.d_model
        self.scale = param((width,), torch.float32, device, axes)
        if cfg.norm == "layernorm" if with_bias is None else with_bias:
            self.bias = param((width,), torch.float32, device, axes)

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.scale.fill_(1.0)
        if "bias" in self._parameters:
            self.bias.zero_()


def apply_norm(params: Norm, x: torch.Tensor, cfg: ModelConfig):
    """Normalise in fp32 and cast back to x.dtype.  Placed, the output's
    gradient is all-reduced here where the branch it feeds left a partial
    sum (a product that contracts over a split dimension: attention's,
    an MLP's, in_proj's, the head's input), the collective XLA emits at
    that product's backward, so the residual stream's gradient stays
    whole and no constraint or norm below has DTensor reduce it."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
    y = y * params.scale
    if "bias" in params._parameters:
        y = y + params.bias
    return reduced_grad(y.to(x.dtype))


# --------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs         # (..,S,half)
    cos = torch.cos(angles)[..., :, None, :]                  # (..,S,1,half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP (gated and plain)
# --------------------------------------------------------------------------

class MLP(nn.Module):
    """``wi`` (d, d_ff), ``wo`` (d_ff, d), and ``wg`` for gated acts;
    ``d_ff`` defaults to the config's (the MoE shared expert is
    ``num_shared_experts * moe_d_ff`` wide)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        dt, d, f = model_dtype(cfg), cfg.d_model, d_ff or cfg.d_ff
        self.wi = param((d, f), dt, device, ("embed", "mlp"))
        self.wo = param((f, d), dt, device, ("mlp", "embed"))
        if cfg.act in ("silu", "geglu"):
            self.wg = param((d, f), dt, device, ("embed", "mlp"))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in self.parameters():
            dense_init_(w, generator)


def apply_mlp(params: MLP, x: torch.Tensor, cfg: ModelConfig):
    h = x @ params.wi
    if cfg.act == "silu":
        h = F.silu(x @ params.wg) * h
    elif cfg.act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params.wg, approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    # (B, S, f), or a MoE's shared expert's (T, f)
    h = shard(h, "batch", *("seq",) * (h.ndim - 2), "mlp")
    return h @ params.wo


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------

class Embedding(nn.Module):
    """``tok`` (padded_vocab, d), untied ``head`` (d, padded_vocab) and,
    for learned positions, ``pos`` (max(encoder_seq, 32768) rows for an
    encoder-decoder, 32768 otherwise, by d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = model_dtype(cfg)
        self.tok = param((cfg.padded_vocab, cfg.d_model), dt, device,
                         ("vocab", "embed"))
        if not cfg.tie_embeddings:
            self.head = param((cfg.d_model, cfg.padded_vocab), dt, device,
                              ("embed", "vocab"))
        if cfg.pos_emb == "learned":
            rows = (max(cfg.encoder_seq, 32_768) if cfg.is_encoder_decoder
                    else 32_768)
            self.pos = param((rows, cfg.d_model), dt, device,
                             (None, "embed"), table=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.tok, generator, in_axis=1)
        if "head" in self._parameters:
            dense_init_(self.head, generator)
        if "pos" in self._parameters:
            dense_init_(self.pos, generator, in_axis=1)


def embed_tokens(params: Embedding, tokens: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None):
    """Token rows, Gemma's sqrt(d) scale, and with learned positions the
    ``pos`` rows of ``positions`` clipped to the table."""
    # an embedding lookup, not an index: placed, a vocab-split table is
    # DTensor's masked partial (each device its own rows, then one
    # reduction) where an index would first move the table, and DTensor's
    # partitioning of an index's backward (an accumulating scatter) fails
    # on torch 2.11; its backward sums each row's gradient in fp32.  The
    # masked partial is reduced before anything is added to it (torch
    # 2.11 masks an addend on meta tensors with a data-dependent op)
    x = shard(F.embedding(tokens, params.tok), "batch", "seq", "embed_act")
    if cfg.name.startswith("gemma"):
        # by sqrt(d) rounded to x's dtype, held as a Python number: a
        # tensor made here would be a copy to the device (none may run
        # while the decode is captured in a CUDA graph)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    if cfg.pos_emb == "learned" and positions is not None:
        rows = params.pos.shape[0]
        x = x + F.embedding(positions.long().clamp(0, rows - 1), params.pos)
    return shard(x, "batch", "seq", "embed_act")


def lm_head(params: Embedding, x: torch.Tensor, cfg: ModelConfig):
    """Logits over the padded vocabulary."""
    w = params.tok.T if cfg.tie_embeddings else params.head
    return shard(x @ w, "batch", "seq", "vocab")
