"""Attention: MHA/GQA, MLA (DeepSeek) and cross-attention with a (ring) KV cache (port of ``repro.models.attention``).

Cache layout, as in the reference::

    {"k": (B, W, Hkv, hd), "v": (B, W, Hkv, hd), "pos": (B, W) int32}

``pos[b, s]`` is the absolute position held in slot ``s`` (-1 = empty);
the slot of position p is ``p % W``.  Keys are stored after RoPE, so
the mask is the only position-dependent piece at read time.  MLA caches
the compressed latent instead::

    {"ckv": (B, W, kv_lora), "krope": (B, W, rope_dim), "pos": (B, W)}

Prefill runs the flash-attention kernel K2 (where the reference runs
``blockwise_attention`` or ``_attend``): causal self-attention,
bidirectional (``causal=False``, the encoder) and cross-attention
(``kv_x``) alike; MLA's prefill hands it q and k of nope + rope dims and
V at its own ``v_head_dim`` (K2 takes a V head dim of its own).  Decode runs the flash-decode kernel K1
over the updated cache, and over the fixed encoder cache for
cross-attention.  MLA decode keeps the reference's absorbed form in
fp32 (scores against the latent cache, then ``wv_b``), plain PyTorch as
the reference's is jnp: its 128 query heads share one latent "kv head"
576 wide, which K1 does not take.  Kernels go through ``kernels.ops``,
which takes the plain version for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (Norm, apply_norm, apply_rope,
                                       dense_init_, model_dtype, param)


class Attention(nn.Module):
    """``wq``/``wk``/``wv`` (d, heads*hd), ``wo`` (H*hd, d), biases
    ``bq``/``bk``/``bv`` with ``use_qkv_bias``; with MLA instead
    ``wq_a``, ``wq_b``, ``wkv_a``, ``wk_b``, ``wv_b``, ``wo`` and the
    fp32 ``q_norm``/``kv_norm`` scales."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt, d, hd = model_dtype(cfg), cfg.d_model, cfg.head_dim
        H = cfg.num_heads
        if cfg.use_mla:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            self.wq_a = param((d, m.q_lora_rank), dt, device)
            self.wq_b = param((m.q_lora_rank, H * qk), dt, device)
            self.wkv_a = param((d, m.kv_lora_rank + m.qk_rope_head_dim), dt,
                               device)
            self.wk_b = param((m.kv_lora_rank, H * m.qk_nope_head_dim), dt,
                              device)
            self.wv_b = param((m.kv_lora_rank, H * m.v_head_dim), dt, device)
            self.wo = param((H * m.v_head_dim, d), dt, device)
            self.q_norm = Norm(cfg, device, width=m.q_lora_rank,
                               with_bias=False)
            self.kv_norm = Norm(cfg, device, width=m.kv_lora_rank,
                                with_bias=False)
            return
        qd, kvd = H * hd, cfg.num_kv_heads * hd
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
        for name, w in self.named_parameters(recurse=False):
            if name.startswith("b"):
                w.zero_()
            else:
                dense_init_(w, generator)
        for norm in self.children():
            norm.reset_parameters()


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               window: Optional[int] = None, *, layers: int = 0,
               device=None) -> Dict:
    """Empty cache; with ``layers`` > 0 every leaf gains a leading layer
    axis (the model's stacked cache)."""
    w = min(window or (cfg.sliding_window or max_seq), max_seq)
    lead = (layers,) if layers else ()
    dt = model_dtype(cfg)
    pos = torch.full(lead + (batch, w), -1, dtype=torch.int32,
                     device=device)
    if cfg.use_mla:
        m = cfg.mla
        return {
            "ckv": torch.zeros(lead + (batch, w, m.kv_lora_rank), dtype=dt,
                               device=device),
            "krope": torch.zeros(lead + (batch, w, m.qk_rope_head_dim),
                                 dtype=dt, device=device),
            "pos": pos,
        }
    kv = lead + (batch, w, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "pos": pos}


def _proj(params: Attention, x, w: str, heads: int, cfg: ModelConfig):
    """x @ w (+ bias), as (B, S, heads, hd)."""
    y = x @ getattr(params, w)
    if cfg.use_qkv_bias:
        y = y + getattr(params, "b" + w[1:])
    return y.view(x.shape[0], x.shape[1], heads, cfg.head_dim)


def attention_forward(params: Attention, x, cfg: ModelConfig, positions,
                      *, causal: bool = True, return_cache: bool = False,
                      window: Optional[int] = None, kv_x=None):
    """x: (B, S, D); positions: (B, S).  ``kv_x`` (B, T, D): cross-
    attention on it, no mask; ``causal=False``: bidirectional.  Returns
    (y, cache or None)."""
    if cfg.use_mla:
        return _mla_forward(params, x, cfg, positions,
                            return_cache=return_cache)
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _proj(params, x, "wq", cfg.num_heads, cfg)
    k = _proj(params, src, "wk", cfg.num_kv_heads, cfg)
    v = _proj(params, src, "wv", cfg.num_kv_heads, cfg)
    if cfg.pos_emb == "rope" and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if causal and kv_x is None:
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            positions, positions, scale=scale, causal=True,
            window=window or cfg.sliding_window)
    else:   # bidirectional (encoder) or cross attention: every key kept
        T = src.shape[1]
        kpos = torch.arange(T, dtype=torch.int32, device=x.device)
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            positions, kpos[None].expand(B, T), scale=scale, causal=False)
    y = out.transpose(1, 2).reshape(B, S, -1) @ params.wo
    if not return_cache:
        return y, None
    return y, {"k": k, "v": v, "pos": positions.to(torch.int32)}


def attention_decode(params: Attention, x, cfg: ModelConfig, cache: Dict,
                     cur_pos, window: Optional[int] = None):
    """x: (B, 1, D); cur_pos: (B,) absolute position of the new token.

    Writes the new K/V (MLA: latent) and position at slot
    ``cur_pos % W`` of ``cache`` in place (the reference builds a new
    cache) and returns ``(y, cache)``.
    """
    if cfg.use_mla:
        return _mla_decode(params, x, cfg, cache, cur_pos)
    B = x.shape[0]
    q = _proj(params, x, "wq", cfg.num_heads, cfg)
    k = _proj(params, x, "wk", cfg.num_kv_heads, cfg)
    v = _proj(params, x, "wv", cfg.num_kv_heads, cfg)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, cur_pos[:, None], cfg.rope_theta)
        k = apply_rope(k, cur_pos[:, None], cfg.rope_theta)
    _write(cache, cur_pos, k=k[:, 0], v=v[:, 0])
    out = ops.decode_attention(
        q[:, 0], cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
        cache["pos"], cur_pos, scale=1.0 / math.sqrt(cfg.head_dim),
        window=window or cfg.sliding_window)
    y = out.reshape(B, 1, -1) @ params.wo
    return y, cache


def _write(cache: Dict, cur_pos, **rows) -> None:
    """Write each row and cur_pos at slot cur_pos % W, in place."""
    pc = cache["pos"]
    slot = torch.remainder(cur_pos, pc.shape[1])
    bidx = torch.arange(pc.shape[0], device=pc.device)
    for name, row in rows.items():
        cache[name][bidx, slot] = row.to(cache[name].dtype)
    pc[bidx, slot] = cur_pos.to(torch.int32)


def cross_attention_decode(params: Attention, x, cfg: ModelConfig,
                           cross_cache: Dict):
    """Decoder cross-attention against the fixed encoder cache
    ``{"k", "v": (B, T, Hkv, hd)}``: K1 with key positions 0..T-1 and
    every query at T-1, so every slot is kept."""
    B = x.shape[0]
    kc, vc = cross_cache["k"], cross_cache["v"]
    T = kc.shape[1]
    q = _proj(params, x, "wq", cfg.num_heads, cfg)
    kpos = torch.arange(T, dtype=torch.int32, device=x.device)
    cur = torch.full((B,), T - 1, dtype=torch.int32, device=x.device)
    out = ops.decode_attention(
        q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2),
        kpos[None].expand(B, T), cur, scale=1.0 / math.sqrt(cfg.head_dim))
    return out.reshape(B, 1, -1) @ params.wo


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def _mla_q(params: Attention, x, cfg: ModelConfig, positions):
    """(q_nope, q_rope), (B, S, H, nope) and (B, S, H, rope) after RoPE."""
    m = cfg.mla
    B, S, _ = x.shape
    q_lat = apply_norm(params.q_norm, x @ params.wq_a, cfg)
    q = (q_lat @ params.wq_b).view(
        B, S, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv(params: Attention, x, cfg: ModelConfig, positions):
    """The latent (B, S, kv_lora), normed, and k_rope (B, S, rope)."""
    m = cfg.mla
    kv = x @ params.wkv_a
    ckv, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    ckv = apply_norm(params.kv_norm, ckv, cfg)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def _mla_forward(params: Attention, x, cfg: ModelConfig, positions, *,
                 return_cache: bool):
    """Causal MLA prefill through K2: q and k are nope + rope wide, V and
    the output v_head_dim wide, as the reference hands them to
    ``blockwise_attention``."""
    m = cfg.mla
    B, S, _ = x.shape
    H, nope, vd = cfg.num_heads, m.qk_nope_head_dim, m.v_head_dim
    hd = nope + m.qk_rope_head_dim
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    ckv, k_rope = _mla_kv(params, x, cfg, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.empty((B, S, H, hd), dtype=x.dtype, device=x.device)
    k[..., :nope] = (ckv @ params.wk_b).view(B, S, H, nope)
    k[..., nope:] = k_rope[:, :, None, :]
    v = (ckv @ params.wv_b).view(B, S, H, vd)
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), positions,
        positions, scale=1.0 / math.sqrt(hd), causal=True, window=0)
    y = out.transpose(1, 2).reshape(B, S, H * vd) @ params.wo
    if not return_cache:
        return y, None
    return y, {"ckv": ckv, "krope": k_rope,
               "pos": positions.to(torch.int32)}


def _mla_decode(params: Attention, x, cfg: ModelConfig, cache: Dict,
                cur_pos):
    """Absorbed-matrix MLA decode: attention runs in the latent space."""
    B = x.shape[0]
    q_nope, q_rope = _mla_q(params, x, cfg, cur_pos[:, None])
    ckv, k_rope = _mla_kv(params, x, cfg, cur_pos[:, None])
    _write(cache, cur_pos, ckv=ckv[:, 0], krope=k_rope[:, 0])
    out = _mla_latent_attention(params, q_nope, q_rope, cache, cur_pos, cfg)
    y = out.reshape(B, 1, -1).to(x.dtype) @ params.wo
    return y, cache


def _mla_latent_attention(params: Attention, q_nope, q_rope, cache: Dict,
                          cur_pos, cfg: ModelConfig):
    """fp32 (full fp32 products: the port never enables TF32): ``wk_b``
    absorbed into q, scores against the latent cache and its rope keys,
    the context in the latent space, then ``wv_b``.  Returns (B, 1, H,
    v_head_dim) fp32."""
    m = cfg.mla
    H, lora = cfg.num_heads, m.kv_lora_rank
    ckv = cache["ckv"].float()
    wk_b = params.wk_b.view(lora, H, m.qk_nope_head_dim).float()
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope.float(), wk_b)
    scores = torch.einsum("bshl,btl->bhst", q_abs, ckv)
    scores = scores + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                   cache["krope"].float())
    scores = scores * (1.0 / math.sqrt(m.qk_nope_head_dim
                                       + m.qk_rope_head_dim))
    kp = cache["pos"]
    mask = (kp <= cur_pos[:, None]) & (kp >= 0)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btl->bshl", w, ckv)
    wv_b = params.wv_b.view(lora, H, m.v_head_dim).float()
    return torch.einsum("bshl,lhv->bshv", ctx, wv_b)
