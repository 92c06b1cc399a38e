"""Model facade: init / forward / decode for the dense, SSM and hybrid families (port of ``repro.models.model``).

``batch`` is ``{"tokens": (B, S) integer tensor}``.  Decode caches, built
by ``init_decode_cache`` and updated in place by ``decode_step``
(``pos == -1`` marks an empty attention slot):

    dense:  {"dense": {"k","v": (L, B, W, Hkv, hd), "pos": (L, B, W)}}
    ssm:    {"ssm": {"conv": (L, B, 3, di+2N), "ssm": (L, B, H, P, N)}}
    hybrid: the ssm cache plus {"attn": {"k","v","pos"}} stacked over
            the shared block's groups (G, B, W, ...)

``params`` is the :class:`~repro_torch.models.transformer.LM` built by
:func:`init` or by ``convert.params_from_reference``.  The MoE, audio
and VLM families raise.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_tokens, lm_head


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> tfm.LM:
    """Random weights drawn on ``device`` (CUDA unless asked otherwise).

    ``jax.random`` cannot be reproduced in torch, so the values differ
    from ``repro.models.model.init``; the scales are the reference's.
    Without a generator, one seeded with 0 on ``device`` is used.
    """
    tfm.check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return tfm.init_lm(cfg, generator, dev)


@torch.no_grad()
def forward(cfg: ModelConfig, params: tfm.LM, batch: Dict, *,
            return_cache: bool = False, window: Optional[int] = None):
    """Returns (logits (B, S, padded_vocab), cache or None, aux_loss)."""
    tfm.check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = embed_tokens(params.embed, tokens, cfg)
    backbone = (tfm.ssm_backbone_forward if tfm.is_ssm(cfg)
                else tfm.backbone_forward)
    h, cache, aux = backbone(params, x, cfg, positions, window=window,
                             return_cache=return_cache)
    return lm_head(params.embed, h, cfg), cache, aux


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: tfm.LM, tokens, cache, cur_pos,
                *, window: Optional[int] = None):
    """tokens: (B, 1); cur_pos: (B,).  Returns (logits, cache), the cache
    updated in place."""
    tfm.check_family(cfg)
    x = embed_tokens(params.embed, tokens, cfg)
    backbone = (tfm.ssm_backbone_decode if tfm.is_ssm(cfg)
                else tfm.backbone_decode)
    h, cache = backbone(params, x, cfg, cache, cur_pos, window=window)
    return lm_head(params.embed, h, cfg), cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      window: Optional[int] = None,
                      device: DeviceLike = None) -> Dict:
    """Empty stacked cache on ``device`` (CUDA unless asked otherwise)."""
    tfm.check_family(cfg)
    dev = resolve_device(device)
    if not tfm.is_ssm(cfg):
        return {"dense": attn.init_cache(cfg, batch, max_seq, window,
                                         layers=cfg.num_layers, device=dev)}
    cache = {"ssm": ssm_mod.init_ssm_cache(cfg, batch,
                                           layers=cfg.num_layers, device=dev)}
    if cfg.family == "hybrid":
        cache["attn"] = attn.init_cache(
            cfg, batch, max_seq, window,
            layers=len(tfm._hybrid_groups(cfg)), device=dev)
    return cache
