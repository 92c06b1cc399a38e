"""Decoder-only LM backbones: dense, MoE, SSM and hybrid (port of ``repro.models.transformer``).

The reference stacks each layer's leaves along a leading axis and runs
the stack under ``lax.scan``; here the layers are a ``ModuleList`` run
by a Python loop, and the per-layer caches are stacked (forward) or
indexed (decode) along the same leading axis, leaf by leaf under each
layer cache's own names (``k``/``v``/``pos``, MLA's ``ckv``/``krope``/
``pos``).  A MoE model runs its ``num_dense_layers`` dense blocks, then
its MoE blocks.  The hybrid (Zamba2) applies one weight-shared attention
block after every ``attn_every`` SSM layers.  With ``remat`` each layer
of a stack runs under ``torch.utils.checkpoint`` (non-reentrant, one
layer per checkpoint: the reference's ``jax.checkpoint`` with
``nothing_saveable`` over its scanned stacks); the hybrid's shared
block, outside the reference's scans, is not recomputed.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (MLP, Embedding, Norm, apply_mlp,
                                       apply_norm)


class Block(nn.Module):
    """``norm1``, ``attn``, ``norm2`` and ``mlp``, or ``moe`` in a MoE
    layer."""

    def __init__(self, cfg: ModelConfig, device=None, moe_layer: bool = False):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.norm2 = Norm(cfg, device)
        if moe_layer:
            self.moe = moe_mod.MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class SSMBlock(nn.Module):
    """``norm``, ``mixer``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm = Norm(cfg, device)
        self.mixer = ssm_mod.SSM(cfg, device)


def is_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def run_layer(fn, *args, remat: bool = False):
    """fn(*args), recomputed in the backward pass when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def layer_counts(cfg: ModelConfig):
    """(dense, moe) block counts: a MoE model's first
    ``num_dense_layers`` blocks are dense."""
    n_dense = cfg.num_dense_layers if cfg.num_experts else cfg.num_layers
    return n_dense, cfg.num_layers - n_dense


class LM(nn.Module):
    """``embed``, ``final_norm`` and either the ``dense_layers`` and
    ``moe_layers`` stacks (each present when non-empty) or the SSM
    ``layers`` stack, plus, with ``attn_every``, the hybrid's
    ``shared_attn`` block."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.embed = Embedding(cfg, device)
        self.final_norm = Norm(cfg, device)
        if not is_ssm(cfg):
            n_dense, n_moe = layer_counts(cfg)
            if n_dense:
                self.dense_layers = nn.ModuleList(
                    Block(cfg, device) for _ in range(n_dense))
            if n_moe:
                self.moe_layers = nn.ModuleList(
                    Block(cfg, device, moe_layer=True) for _ in range(n_moe))
            return
        self.layers = nn.ModuleList(
            SSMBlock(cfg, device) for _ in range(cfg.num_layers))
        if cfg.attn_every:
            self.shared_attn = Block(cfg, device)


def stacks(params: LM):
    """(cache key, blocks) of the attention stacks present, in order."""
    return [(key, params._modules[name]) for key, name in
            (("dense", "dense_layers"), ("moe", "moe_layers"))
            if name in params._modules]


def _reset_block(blk: Block, generator: torch.Generator) -> None:
    blk.norm1.reset_parameters()
    blk.attn.reset_parameters(generator)
    blk.norm2.reset_parameters()
    ffn = blk.moe if "moe" in blk._modules else blk.mlp
    ffn.reset_parameters(generator)


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device=None) -> LM:
    """Random weights with the reference's scales, drawn on ``device``."""
    lm = LM(cfg, device)
    lm.embed.reset_parameters(generator)
    lm.final_norm.reset_parameters()
    if not is_ssm(cfg):
        for _, blocks in stacks(lm):
            for blk in blocks:
                _reset_block(blk, generator)
        return lm
    for blk in lm.layers:
        blk.norm.reset_parameters()
        blk.mixer.reset_parameters(generator)
    if cfg.attn_every:
        _reset_block(lm.shared_attn, generator)
    return lm


def _ffn(params: Block, h, cfg: ModelConfig, decode: bool):
    """(out, aux): the MoE layer's aux loss, 0.0 for a dense one."""
    if "moe" in params._modules:
        return moe_mod.apply_moe(params.moe, h, cfg, decode=decode)
    return apply_mlp(params.mlp, h, cfg), 0.0


def apply_block(params: Block, x, cfg: ModelConfig, positions, *,
                window: Optional[int] = None, return_cache: bool = False):
    """Full-sequence block.  Returns (x, cache, aux)."""
    h = apply_norm(params.norm1, x, cfg)
    a, cache = attn.attention_forward(params.attn, h, cfg, positions,
                                      return_cache=return_cache,
                                      window=window)
    x = x + a
    f, aux = _ffn(params, apply_norm(params.norm2, x, cfg), cfg, False)
    return x + f, cache, aux


def apply_block_decode(params: Block, x, cfg: ModelConfig, cache, cur_pos,
                       *, window: Optional[int] = None):
    h = apply_norm(params.norm1, x, cfg)
    a, cache = attn.attention_decode(params.attn, h, cfg, cache, cur_pos,
                                     window=window)
    x = x + a
    f, _ = _ffn(params, apply_norm(params.norm2, x, cfg), cfg, True)
    return x + f, cache


def stack_caches(caches: List[Dict]) -> Dict:
    """Per-layer caches stacked leaf by leaf along a leading layer axis."""
    return {name: torch.stack([c[name] for c in caches])
            for name in caches[0]}


def layer_cache(stack: Dict, i: int) -> Dict:
    """Layer i's views of a stacked cache (written through in place)."""
    return {name: leaf[i] for name, leaf in stack.items()}


def backbone_forward(params: LM, x, cfg: ModelConfig, positions, *,
                     window: Optional[int] = None,
                     return_cache: bool = False, remat: bool = False):
    """x: (B, S, D) embeddings -> (hidden, cache or None, aux_loss).

    The cache is ``{"dense": ..., "moe": ...}`` (the stacks present);
    aux_loss sums the MoE layers' losses in fp32 (0.0 without experts).
    """
    caches: Dict[str, Dict] = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
        if cfg.num_experts else 0.0

    def step(blk, h):
        return apply_block(blk, h, cfg, positions, window=window,
                           return_cache=return_cache)

    for key, blocks in stacks(params):
        layer = []
        for blk in blocks:
            x, c, aux = run_layer(step, blk, x, remat=remat)
            aux_total = aux_total + aux
            layer.append(c)
        if return_cache:
            caches[key] = stack_caches(layer)
    x = apply_norm(params.final_norm, x, cfg)
    return x, (caches if return_cache else None), aux_total


def backbone_decode(params: LM, x, cfg: ModelConfig, cache: Dict, cur_pos,
                    *, window: Optional[int] = None):
    """One token per sequence; updates each stack's cache in place."""
    for key, blocks in stacks(params):
        for i, blk in enumerate(blocks):
            x, _ = apply_block_decode(blk, x, cfg, layer_cache(cache[key], i),
                                      cur_pos, window=window)
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
                         return_cache: bool = False, remat: bool = False,
                         window: Optional[int] = None):
    """x: (B, S, D) embeddings -> (hidden, cache or None, aux_loss).

    The cache is ``{"ssm": {"conv", "ssm"}}`` stacked over the SSM
    layers and, for the hybrid, ``"attn": {"k", "v", "pos"}`` stacked
    over the groups.
    """
    def step(blk, h):
        return apply_ssm_block(blk, h, cfg, return_cache=return_cache)

    ssm_caches, attn_caches = [], []
    for lo, hi in _hybrid_groups(cfg):
        for blk in params.layers[lo:hi]:
            x, c = run_layer(step, blk, x, remat=remat)
            ssm_caches.append(c)
        if cfg.attn_every:
            x, c, _ = apply_block(params.shared_attn, x, cfg, positions,
                                  window=window, return_cache=return_cache)
            attn_caches.append(c)
    x = apply_norm(params.final_norm, x, cfg)
    if not return_cache:
        return x, None, 0.0
    cache = {"ssm": stack_caches(ssm_caches)}
    if attn_caches:
        cache["attn"] = stack_caches(attn_caches)
    return x, cache, 0.0


def ssm_backbone_decode(params: LM, x, cfg: ModelConfig, cache: Dict,
                        cur_pos, *, window: Optional[int] = None):
    """One token per sequence; updates ``cache`` in place: SSM layer i
    reads and writes ``cache["ssm"][name][i]``, the shared block after
    group g ``cache["attn"][name][g]``."""
    ssm = cache["ssm"]
    for g, (lo, hi) in enumerate(_hybrid_groups(cfg)):
        for i in range(lo, hi):
            x, _ = apply_ssm_block(params.layers[i], x, cfg,
                                   cache=layer_cache(ssm, i))
        if cfg.attn_every:
            x, _ = apply_block_decode(params.shared_attn, x, cfg,
                                      layer_cache(cache["attn"], g),
                                      cur_pos, window=window)
    x = apply_norm(params.final_norm, x, cfg)
    return x, cache
