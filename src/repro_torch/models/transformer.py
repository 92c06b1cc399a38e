"""Decoder-only LM backbones: dense, SSM and hybrid (port of ``repro.models.transformer``).

The reference stacks each layer's leaves along a leading axis and runs
the stack under ``lax.scan``; here the layers are a ``ModuleList`` run
by a Python loop, and the per-layer caches are stacked (forward) or
indexed (decode) along the same leading axis.  The hybrid (Zamba2)
applies one weight-shared attention block after every ``attn_every``
SSM layers.  The MoE stack is not ported yet and raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
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


class SSMBlock(nn.Module):
    """``norm``, ``mixer``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm = Norm(cfg, device)
        self.mixer = ssm_mod.SSM(cfg, device)


def check_family(cfg: ModelConfig) -> None:
    """Raise for every family but the ported ones: dense (without
    experts), ssm and hybrid."""
    dense = cfg.family == "dense" and not cfg.num_experts
    if not (dense or cfg.family in ("ssm", "hybrid")):
        raise not_ported(f"model family {cfg.family!r}")


def is_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


class LM(nn.Module):
    """``embed``, ``final_norm`` and either the ``dense_layers`` stack
    or the SSM ``layers`` stack, plus, with ``attn_every``, the hybrid's
    ``shared_attn`` block."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.embed = Embedding(cfg, device)
        self.final_norm = Norm(cfg, device)
        if not is_ssm(cfg):
            self.dense_layers = nn.ModuleList(
                Block(cfg, device) for _ in range(cfg.num_layers))
            return
        self.layers = nn.ModuleList(
            SSMBlock(cfg, device) for _ in range(cfg.num_layers))
        if cfg.attn_every:
            self.shared_attn = Block(cfg, device)


def _reset_block(blk: Block, generator: torch.Generator) -> None:
    blk.norm1.reset_parameters()
    blk.attn.reset_parameters(generator)
    blk.norm2.reset_parameters()
    blk.mlp.reset_parameters(generator)


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device=None) -> LM:
    """Random weights with the reference's scales, drawn on ``device``."""
    lm = LM(cfg, device)
    lm.embed.reset_parameters(generator)
    lm.final_norm.reset_parameters()
    if not is_ssm(cfg):
        for blk in lm.dense_layers:
            _reset_block(blk, generator)
        return lm
    for blk in lm.layers:
        blk.norm.reset_parameters()
        blk.mixer.reset_parameters(generator)
    if cfg.attn_every:
        _reset_block(lm.shared_attn, generator)
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


# --------------------------------------------------------------------------
# SSM / hybrid LM
# --------------------------------------------------------------------------

def apply_ssm_block(params: SSMBlock, x, cfg: ModelConfig, *,
                    return_cache: bool = False, cache=None):
    """Prefill (``cache`` None) or, with a layer's cache, one decode
    step, which updates that cache in place.  Returns (x, cache)."""
    h = apply_norm(params.norm, x, cfg)
    if cache is None:
        y, cache = ssm_mod.ssm_forward(params.mixer, h, cfg,
                                       return_cache=return_cache)
    else:
        y, cache = ssm_mod.ssm_decode(params.mixer, h, cfg, cache)
    return x + y, cache


def _hybrid_groups(cfg: ModelConfig):
    """[lo, hi) ranges of SSM layers, each followed by the shared
    attention block (the last range holds the remainder); without
    ``attn_every``, one range of all layers."""
    n, k = cfg.num_layers, cfg.attn_every or cfg.num_layers
    return [(lo, min(lo + k, n)) for lo in range(0, n, k)]


def ssm_backbone_forward(params: LM, x, cfg: ModelConfig, positions, *,
                         return_cache: bool = False,
                         window: Optional[int] = None):
    """x: (B, S, D) embeddings -> (hidden, cache or None, aux_loss).

    The cache is ``{"ssm": {"conv", "ssm"}}`` stacked over the SSM
    layers and, for the hybrid, ``"attn": {"k", "v", "pos"}`` stacked
    over the groups.
    """
    ssm_caches, attn_caches = [], []
    for lo, hi in _hybrid_groups(cfg):
        for blk in params.layers[lo:hi]:
            x, c = apply_ssm_block(blk, x, cfg, return_cache=return_cache)
            ssm_caches.append(c)
        if cfg.attn_every:
            x, c = apply_block(params.shared_attn, x, cfg, positions,
                               window=window, return_cache=return_cache)
            attn_caches.append(c)
    x = apply_norm(params.final_norm, x, cfg)
    if not return_cache:
        return x, None, 0.0
    cache = {"ssm": {name: torch.stack([c[name] for c in ssm_caches])
                     for name in ("conv", "ssm")}}
    if attn_caches:
        cache["attn"] = {name: torch.stack([c[name] for c in attn_caches])
                         for name in ("k", "v", "pos")}
    return x, cache, 0.0


def ssm_backbone_decode(params: LM, x, cfg: ModelConfig, cache: Dict,
                        cur_pos, *, window: Optional[int] = None):
    """One token per sequence; updates ``cache`` in place: SSM layer i
    reads and writes ``cache["ssm"][name][i]``, the shared block after
    group g ``cache["attn"][name][g]``."""
    ssm = cache["ssm"]
    for g, (lo, hi) in enumerate(_hybrid_groups(cfg)):
        for i in range(lo, hi):
            layer = {name: ssm[name][i] for name in ("conv", "ssm")}
            x, _ = apply_ssm_block(params.layers[i], x, cfg, cache=layer)
        if cfg.attn_every:
            layer = {name: cache["attn"][name][g]
                     for name in ("k", "v", "pos")}
            x, _ = apply_block_decode(params.shared_attn, x, cfg, layer,
                                      cur_pos, window=window)
    x = apply_norm(params.final_norm, x, cfg)
    return x, cache
