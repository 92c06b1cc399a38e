"""Dense decoder-only LM backbone (port of ``repro.models.transformer``).

The reference stacks each layer's leaves along a leading axis and runs
the stack under ``lax.scan``; here the layers are a ``ModuleList`` run
by a Python loop, and the per-layer caches are stacked (forward) or
indexed (decode) along the same leading axis.  MoE, SSM and hybrid
stacks are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embedding, Norm, apply_mlp,
                                       apply_norm, not_ported)


class Block(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.norm2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)


def check_dense(cfg: ModelConfig) -> None:
    """Raise for every family but the dense one, the only one ported."""
    if cfg.family != "dense" or cfg.num_experts:
        raise not_ported(f"model family {cfg.family!r}")


class LM(nn.Module):
    """``embed``, ``final_norm`` and the ``dense_layers`` stack."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_dense(cfg)
        self.embed = Embedding(cfg, device)
        self.final_norm = Norm(cfg, device)
        self.dense_layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device=None) -> LM:
    """Random weights with the reference's scales, drawn on ``device``."""
    lm = LM(cfg, device)
    lm.embed.reset_parameters(generator)
    lm.final_norm.reset_parameters()
    for blk in lm.dense_layers:
        blk.norm1.reset_parameters()
        blk.attn.reset_parameters(generator)
        blk.norm2.reset_parameters()
        blk.mlp.reset_parameters(generator)
    return lm


def apply_block(params: Block, x, cfg: ModelConfig, positions, *,
                window: Optional[int] = None, return_cache: bool = False):
    """Full-sequence block.  Returns (x, cache)."""
    h = apply_norm(params.norm1, x, cfg)
    a, cache = attn.attention_forward(params.attn, h, cfg, positions,
                                      return_cache=return_cache,
                                      window=window)
    x = x + a
    h = apply_norm(params.norm2, x, cfg)
    return x + apply_mlp(params.mlp, h, cfg), cache


def apply_block_decode(params: Block, x, cfg: ModelConfig, cache, cur_pos,
                       *, window: Optional[int] = None):
    h = apply_norm(params.norm1, x, cfg)
    a, cache = attn.attention_decode(params.attn, h, cfg, cache, cur_pos,
                                     window=window)
    x = x + a
    h = apply_norm(params.norm2, x, cfg)
    return x + apply_mlp(params.mlp, h, cfg), cache


def backbone_forward(params: LM, x, cfg: ModelConfig, positions, *,
                     window: Optional[int] = None,
                     return_cache: bool = False):
    """x: (B, S, D) embeddings -> (hidden, cache or None, aux_loss)."""
    caches = []
    for blk in params.dense_layers:
        x, c = apply_block(blk, x, cfg, positions, window=window,
                           return_cache=return_cache)
        caches.append(c)
    x = apply_norm(params.final_norm, x, cfg)
    if not return_cache:
        return x, None, 0.0
    stacked = {name: torch.stack([c[name] for c in caches])
               for name in ("k", "v", "pos")}
    return x, {"dense": stacked}, 0.0


def backbone_decode(params: LM, x, cfg: ModelConfig, cache: Dict, cur_pos,
                    *, window: Optional[int] = None):
    """One token per sequence; updates ``cache["dense"]`` in place."""
    stack = cache["dense"]
    for i, blk in enumerate(params.dense_layers):
        layer = {name: stack[name][i] for name in ("k", "v", "pos")}
        x, _ = apply_block_decode(blk, x, cfg, layer, cur_pos, window=window)
    x = apply_norm(params.final_norm, x, cfg)
    return x, cache
