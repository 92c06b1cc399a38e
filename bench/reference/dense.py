"""Plain float32 reference of the dense decoder (StarCoder2's family).

Pre-norm blocks: ``x += attn(norm1(x))``, ``x += mlp(norm2(x))``;
LayerNorm or RMSNorm in float32, q/k/v projections with optional bias,
RoPE over split halves, causal grouped-query attention (each key/value
head serves ``H / Hkv`` query heads), a GELU (tanh) MLP or a gated
SiLU one, a final norm and an untied head over the padded vocabulary.
Every product runs in float32 with TF32 off, from the benchmark's
weights (``harness.weights``, weights ``(in, out)``).

It runs layer by layer over a list of sequences, each weight cast to
float32 once per layer, so it fits beside nothing else on the card.
``mm`` is the product of two float32 tensors: ``precision.exact`` for
the reference, ``precision.fp8`` for the control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def norm(x: torch.Tensor, w: Dict, prefix: str, m: Dict) -> torch.Tensor:
    scale = w[f"{prefix}.scale"].float()
    if m["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + m["norm_eps"]) * scale \
            + w[f"{prefix}.bias"].float()
    ms = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + m["norm_eps"]) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, hd) at positions 0..S-1; halves rotated, not
    interleaved."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h: torch.Tensor, lw: Dict, m: Dict, mm: MM) -> torch.Tensor:
    """Causal GQA self-attention of h (S, d) with one block's float32
    weights ``lw`` (keys ``wq``, ``wk``, ``wv``, ``wo``, biases)."""
    S = h.shape[0]
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]

    def proj(name, heads):
        y = mm(h, lw["w" + name])
        if "b" + name in lw:
            y = y + lw["b" + name]
        return y.view(S, heads, hd)

    q = rope(proj("q", H), m["rope_theta"])
    k = rope(proj("k", Hkv), m["rope_theta"])
    v = proj("v", Hkv)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
    out = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * hd)
    return mm(out, lw["wo"])


def mlp(h: torch.Tensor, lw: Dict, m: Dict, mm: MM) -> torch.Tensor:
    u = mm(h, lw["wi"])
    if m["act"] == "silu":
        u = F.silu(mm(h, lw["wg"])) * u
    elif m["act"] == "gelu":
        u = F.gelu(u, approximate="tanh")
    else:
        raise ValueError(f"no reference for act {m['act']!r}")
    return mm(u, lw["wo"])


def sub(w: Dict, prefix: str) -> Dict:
    """The leaves under ``prefix``, keyed by the rest of their names and
    cast to float32 once."""
    n = len(prefix) + 1
    return {k[n:]: t.float() for k, t in w.items()
            if k.startswith(prefix + ".")}


def block(xs: List[torch.Tensor], w: Dict, prefix: str, m: Dict,
          mm: MM) -> List[torch.Tensor]:
    """Block ``prefix`` applied to each sequence's residual stream in
    ``xs`` ((S, d) float32 tensors), its weights cast once for all."""
    aw, fw = sub(w, f"{prefix}.attn"), sub(w, f"{prefix}.mlp")
    out = []
    for x in xs:
        x = x + attention(norm(x, w, f"{prefix}.norm1", m), aw, m, mm)
        out.append(x + mlp(norm(x, w, f"{prefix}.norm2", m), fw, m, mm))
    return out


def embed(w: Dict, seqs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [w["embed.tok"][s].float() for s in seqs]


def head(w: Dict, xs: List[torch.Tensor], firsts: List[int], m: Dict,
         mm: MM) -> List[torch.Tensor]:
    """Logits (S - first, padded vocab) of each sequence's positions
    from ``first`` on."""
    hw = w["embed.head"].float()
    return [mm(norm(x[f:], w, "final_norm", m), hw)
            for x, f in zip(xs, firsts)]


@torch.no_grad()
def forward(w: Dict, m: Dict, seqs: List[torch.Tensor], firsts: List[int],
            mm: MM) -> List[torch.Tensor]:
    """Float32 logits of each token sequence in ``seqs`` (1-D, on the
    weights' device) at its positions ``first`` and after."""
    xs = embed(w, seqs)
    for i in range(m["num_layers"]):
        xs = block(xs, w, f"dense_layers.{i}", m, mm)
    return head(w, xs, firsts, m, mm)
