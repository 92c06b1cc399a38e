"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The mel-spectrogram and conv front end are stubbed, as in the reference:
``frames`` arrive as (B, encoder_seq, d_model) embeddings.  The encoder
is bidirectional; each decoder block runs causal self-attention, then
cross-attention on the encoder memory (both through K2 in prefill).
Decode keeps a self-attention KV cache (K1) and reads a fixed
cross-attention cache ``{"k", "v": (L, B, encoder_seq, Hkv, hd)}``
built once from the memory (K1 with every slot kept); nothing writes it
after the prefill.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embedding, Norm, apply_mlp,
                                       apply_norm, embed_tokens,
                                       model_dtype, param)
from repro_torch.models.transformer import (layer_cache, run_layer,
                                            stack_caches)


class EncBlock(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.norm2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)


class DecBlock(nn.Module):
    """``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.self_attn = attn.Attention(cfg, device)
        self.norm_x = Norm(cfg, device)
        self.cross_attn = attn.Attention(cfg, device)
        self.norm2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)


class EncDec(nn.Module):
    """``embed``, ``enc_pos`` (encoder_seq, d), the ``enc_layers`` stack,
    ``enc_norm``, the ``dec_layers`` stack and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.embed = Embedding(cfg, device)
        self.enc_pos = param((cfg.encoder_seq, cfg.d_model),
                             model_dtype(cfg), device, (None, "embed"),
                             table=True)
        self.enc_layers = nn.ModuleList(
            EncBlock(cfg, device) for _ in range(cfg.encoder_layers))
        self.enc_norm = Norm(cfg, device)
        self.dec_layers = nn.ModuleList(
            DecBlock(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg, device)


@torch.no_grad()
def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> EncDec:
    """Random weights with the reference's scales (``enc_pos`` is
    0.02 * normal, rounded to the model's dtype first)."""
    m = EncDec(cfg, device)
    m.embed.reset_parameters(generator)
    x = torch.randn(m.enc_pos.shape, generator=generator,
                    device=m.enc_pos.device)
    m.enc_pos.copy_(x.to(m.enc_pos.dtype) * 0.02)
    for blk in list(m.enc_layers) + list(m.dec_layers):
        for child in blk.children():
            if isinstance(child, Norm):
                child.reset_parameters()
            else:
                child.reset_parameters(generator)
    m.enc_norm.reset_parameters()
    m.final_norm.reset_parameters()
    return m


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def encode(params: EncDec, frames, cfg: ModelConfig):
    """frames: (B, T, D) stubbed embeddings -> encoder memory (B, T, D)."""
    B, T, _ = frames.shape
    x = shard(frames + params.enc_pos[:T], "batch", "seq", "embed_act")
    pos = _positions(B, T, frames.device)
    for blk in params.enc_layers:
        a, _ = attn.attention_forward(blk.attn, apply_norm(blk.norm1, x, cfg),
                                      cfg, pos, causal=False)
        x = x + a
        x = _residual(x + apply_mlp(blk.mlp, apply_norm(blk.norm2, x, cfg),
                                    cfg))
    return apply_norm(params.enc_norm, x, cfg)


def _residual(x):
    """A block's output, placed as the transformer block's is (the
    reference's one constraint on the encoder input reaches every block
    by GSPMD's propagation; DTensor would carry the MLP's partial sums
    on into the next block's norm)."""
    return shard(x, "batch", "seq" if x.shape[1] > 1 else None, "embed_act")


def decoder_forward(params: EncDec, tokens, memory, cfg: ModelConfig, *,
                    return_cache: bool = False, remat: bool = False):
    """Causal decoder over ``tokens`` with cross-attention on ``memory``.
    Returns (hidden, self-attention cache stacked over layers or None).
    ``remat``: each decoder layer is recomputed in the backward pass (the
    reference's remat covers the decoder stack, not the encoder)."""
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    x = embed_tokens(params.embed, tokens, cfg, positions=pos)

    def step(blk, x, memory):
        a, c = attn.attention_forward(blk.self_attn,
                                      apply_norm(blk.norm1, x, cfg), cfg,
                                      pos, return_cache=return_cache)
        x = x + a
        a, _ = attn.attention_forward(blk.cross_attn,
                                      apply_norm(blk.norm_x, x, cfg), cfg,
                                      pos, causal=False, kv_x=memory)
        x = x + a
        return _residual(x + apply_mlp(blk.mlp, apply_norm(blk.norm2, x, cfg),
                                       cfg)), c

    caches = []
    for blk in params.dec_layers:
        x, c = run_layer(step, blk, x, memory, remat=remat)
        caches.append(c)
    x = apply_norm(params.final_norm, x, cfg)
    return x, (stack_caches(caches) if return_cache else None)


def build_cross_cache(params: EncDec, memory, cfg: ModelConfig) -> Dict:
    """Every decoder layer's cross-attention K/V of ``memory``, stacked:
    ``{"k", "v": (L, B, T, Hkv, hd)}``."""
    caches = []
    for blk in params.dec_layers:
        ca = blk.cross_attn
        caches.append({"k": attn._proj(ca, memory, "wk", cfg.num_kv_heads,
                                       cfg, "kv_heads"),
                       "v": attn._proj(ca, memory, "wv", cfg.num_kv_heads,
                                       cfg, "kv_heads")})
    return stack_caches(caches)


def decoder_decode(params: EncDec, tokens, cfg: ModelConfig, cache: Dict,
                   cross_cache: Dict, cur_pos):
    """tokens: (B, 1).  Updates the stacked self-attention ``cache`` in
    place; ``cross_cache`` is read only.  Returns (hidden, cache)."""
    x = embed_tokens(params.embed, tokens, cfg, positions=cur_pos[:, None])
    for i, blk in enumerate(params.dec_layers):
        a, _ = attn.attention_decode(blk.self_attn,
                                     apply_norm(blk.norm1, x, cfg), cfg,
                                     layer_cache(cache, i), cur_pos)
        x = x + a
        x = x + attn.cross_attention_decode(
            blk.cross_attn, apply_norm(blk.norm_x, x, cfg), cfg,
            layer_cache(cross_cache, i))
        x = _residual(x + apply_mlp(blk.mlp, apply_norm(blk.norm2, x, cfg),
                                    cfg))
    x = apply_norm(params.final_norm, x, cfg)
    return x, cache
