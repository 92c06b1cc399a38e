"""Plain PyTorch versions of the kernels (the correctness oracles).

Same signatures and layouts as ``repro.kernels.ref``.  Attention: fp32
math, the finite ``NEG_INF`` mask value (a row whose keys are all
masked returns mean(V), not 0 or NaN), output in ``q.dtype``.  Inputs
may be strided views.  ``ops`` runs these for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, q_pos, k_pos, *, scale: float,
                        causal: bool = True, window: int = 0):
    """q: (B,H,S,hd); k/v: (B,Hkv,T,hd); q_pos: (B,S); k_pos: (B,T)."""
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, S, hd).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    kp, qp = k_pos[:, None, :], q_pos[:, :, None]
    mask = (kp >= 0) & (qp >= 0)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return o.reshape(B, H, S, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k, v, k_pos, cur_pos, *, scale: float,
                         window: int = 0):
    """q: (B,H,hd); k/v: (B,Hkv,T,hd); k_pos: (B,T); cur_pos: (B,)."""
    B, H, hd = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) * scale
    cur = cur_pos[:, None]
    mask = (k_pos >= 0) & (k_pos <= cur)
    if window:
        mask &= (cur - k_pos) < window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", w, v.float())
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


def ssd_state_scan_ref(states, decay, s0):
    """Cross-chunk SSD recurrence, S_i = S_{i-1} * decay_i + states_i.

    states: (b,c,h,p,n) fp32; decay: (b,c,h); s0: (b,h,p,n).  Returns
    (prev (b,c,h,p,n), the state entering each chunk, and final
    (b,h,p,n)).  The product and the sum are separate ops (no FMA), which
    the CUDA kernel repeats bit for bit.
    """
    carry = s0
    prev = []
    for i in range(states.shape[1]):
        prev.append(carry)
        carry = carry * decay[:, i, :, None, None] + states[:, i]
    return torch.stack(prev, dim=1), carry
