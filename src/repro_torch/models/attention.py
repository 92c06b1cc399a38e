"""Attention for MHA/GQA with a (ring) KV cache (port of ``repro.models.attention``).

Cache layout, as in the reference::

    {"k": (B, W, Hkv, hd), "v": (B, W, Hkv, hd), "pos": (B, W) int32}

``pos[b, s]`` is the absolute position held in slot ``s`` (-1 = empty);
the slot of position p is ``p % W``.  Keys are stored after RoPE, so
the mask is the only position-dependent piece at read time.

Prefill runs the flash-attention kernel (where the reference runs
``blockwise_attention``), decode the flash-decode kernel over the
updated cache (where the reference runs ``_attend``); both go through
``kernels.ops``, which takes the plain version for CPU tensors.  MLA
and cross-attention are not ported yet and raise.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init_, model_dtype,
                                       not_ported, param)


class Attention(nn.Module):
    """``wq``/``wk``/``wv`` (d, heads*hd), ``wo`` (H*hd, d), biases
    ``bq``/``bk``/``bv`` with ``use_qkv_bias``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.use_mla:
            raise not_ported("multi-head latent attention (MLA)")
        dt, d, hd = model_dtype(cfg), cfg.d_model, cfg.head_dim
        qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.wq = param((d, qd), dt, device)
        self.wk = param((d, kvd), dt, device)
        self.wv = param((d, kvd), dt, device)
        self.wo = param((qd, d), dt, device)
        if cfg.use_qkv_bias:
            self.bq = param((qd,), dt, device)
            self.bk = param((kvd,), dt, device)
            self.bv = param((kvd,), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, w in self.named_parameters():
            if name.startswith("b"):
                w.zero_()
            else:
                dense_init_(w, generator)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               window: Optional[int] = None, *, layers: int = 0,
               device=None) -> Dict:
    """Empty cache; with ``layers`` > 0 every leaf gains a leading layer
    axis (the model's stacked cache)."""
    if cfg.use_mla:
        raise not_ported("the MLA latent cache")
    w = min(window or (cfg.sliding_window or max_seq), max_seq)
    lead = (layers,) if layers else ()
    kv = lead + (batch, w, cfg.num_kv_heads, cfg.head_dim)
    dt = model_dtype(cfg)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "pos": torch.full(lead + (batch, w), -1, dtype=torch.int32,
                          device=device),
    }


def _qkv(params: Attention, x, cfg: ModelConfig):
    q, k, v = x @ params.wq, x @ params.wk, x @ params.wv
    if cfg.use_qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    B, S, _ = x.shape
    hd = cfg.head_dim
    return (q.view(B, S, cfg.num_heads, hd),
            k.view(B, S, cfg.num_kv_heads, hd),
            v.view(B, S, cfg.num_kv_heads, hd))


def attention_forward(params: Attention, x, cfg: ModelConfig, positions,
                      *, causal: bool = True, return_cache: bool = False,
                      window: Optional[int] = None, kv_x=None):
    """x: (B, S, D); positions: (B, S).  Returns (y, cache or None)."""
    if kv_x is not None or not causal:
        raise not_ported("cross and bidirectional attention")
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        positions, positions, scale=1.0 / math.sqrt(cfg.head_dim),
        causal=True, window=window or cfg.sliding_window)
    y = out.transpose(1, 2).reshape(B, S, -1) @ params.wo
    if not return_cache:
        return y, None
    return y, {"k": k, "v": v, "pos": positions.to(torch.int32)}


def attention_decode(params: Attention, x, cfg: ModelConfig, cache: Dict,
                     cur_pos, window: Optional[int] = None):
    """x: (B, 1, D); cur_pos: (B,) absolute position of the new token.

    Writes the new K/V and position at slot ``cur_pos % W`` of ``cache``
    in place (the reference builds a new cache) and returns
    ``(y, cache)``.
    """
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, cur_pos[:, None], cfg.rope_theta)
        k = apply_rope(k, cur_pos[:, None], cfg.rope_theta)
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    slot = torch.remainder(cur_pos, kc.shape[1])
    bidx = torch.arange(B, device=x.device)
    kc[bidx, slot] = k[:, 0].to(kc.dtype)
    vc[bidx, slot] = v[:, 0].to(vc.dtype)
    pc[bidx, slot] = cur_pos.to(torch.int32)
    out = ops.decode_attention(
        q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), pc, cur_pos,
        scale=1.0 / math.sqrt(cfg.head_dim),
        window=window or cfg.sliding_window)
    y = out.reshape(B, 1, -1) @ params.wo
    return y, cache
