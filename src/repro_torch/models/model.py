"""Model facade: init / forward / decode for the dense family (port of ``repro.models.model``).

``batch`` is ``{"tokens": (B, S) integer tensor}``.  The decode cache is
``{"dense": {"k","v": (L, B, W, Hkv, hd), "pos": (L, B, W) int32}}``
(``pos == -1`` marks an empty slot), built by ``init_decode_cache`` and
updated in place by ``decode_step``.  ``params`` is the
:class:`~repro_torch.models.transformer.LM` built by :func:`init` or by
``convert.params_from_reference``.  Every family but ``dense`` raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_tokens, lm_head


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> tfm.LM:
    """Random weights drawn on ``device`` (CUDA unless asked otherwise).

    ``jax.random`` cannot be reproduced in torch, so the values differ
    from ``repro.models.model.init``; the scales are the reference's.
    Without a generator, one seeded with 0 on ``device`` is used.
    """
    tfm.check_dense(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return tfm.init_lm(cfg, generator, dev)


@torch.no_grad()
def forward(cfg: ModelConfig, params: tfm.LM, batch: Dict, *,
            return_cache: bool = False, window: Optional[int] = None):
    """Returns (logits (B, S, padded_vocab), cache or None, aux_loss)."""
    tfm.check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = embed_tokens(params.embed, tokens, cfg)
    h, cache, aux = tfm.backbone_forward(params, x, cfg, positions,
                                         window=window,
                                         return_cache=return_cache)
    return lm_head(params.embed, h, cfg), cache, aux


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: tfm.LM, tokens, cache, cur_pos,
                *, window: Optional[int] = None):
    """tokens: (B, 1); cur_pos: (B,).  Returns (logits, cache), the cache
    updated in place."""
    tfm.check_dense(cfg)
    x = embed_tokens(params.embed, tokens, cfg)
    h, cache = tfm.backbone_decode(params, x, cfg, cache, cur_pos,
                                   window=window)
    return lm_head(params.embed, h, cfg), cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      window: Optional[int] = None,
                      device: DeviceLike = None) -> Dict:
    """Empty stacked cache on ``device`` (CUDA unless asked otherwise)."""
    tfm.check_dense(cfg)
    return {"dense": attn.init_cache(cfg, batch, max_seq, window,
                                     layers=cfg.num_layers,
                                     device=resolve_device(device))}
