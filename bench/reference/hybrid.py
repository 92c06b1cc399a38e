"""Plain float32 reference of the hybrid model (Zamba2's family).

Mamba2 layers, ``x += mixer(rmsnorm(x))``, and after every
``attn_every`` of them (and after the last, shorter group) one
attention + MLP block whose weights all applications share
(``dense.block`` under the prefix ``shared_attn``).

The mixer: ``in_proj`` gives [z | x B C | dt]; a causal depthwise
convolution of width 4 with bias over [x B C], then SiLU; ``dt =
softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the state-space recurrence
per head, state (P, N):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t + D x_t

(B and C shared by all heads); ``y * silu(z)``, an RMS norm with eps
1e-6 scaled by ``gate_norm``, and ``out_proj``.  The recurrence is
computed exactly, a chunk of ``CHUNK`` positions at a time: within a
chunk as the sum over earlier positions of their decayed inputs, across
chunks by carrying the state.  Everything in float32, TF32 off, from the
benchmark's weights.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from bench.reference.dense import MM, block, embed, head, norm, sub

CHUNK = 128
CONV_WIDTH = 4


def ssd(x, dt, A, Bm, Cm):
    """x: (L, H, P); dt: (L, H); A: (H,); Bm, Cm: (L, N).  Returns y
    (L, H, P) of the recurrence from a zero state."""
    L, H, P = x.shape
    N = Bm.shape[1]
    h = torch.zeros(H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, L, CHUNK):
        xs, d, b, c = (t[lo:lo + CHUNK] for t in (x, dt, Bm, Cm))
        cs = torch.cumsum(d * A, dim=0)                       # (l, H)
        # decay from position j to i (i >= j): exp(cs_i - cs_j)
        seg = cs[:, None, :] - cs[None, :, :]                 # (i, j, H)
        keep = torch.ones(len(d), len(d), dtype=torch.bool,
                          device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~keep[:, :, None], -math.inf))
        w = (c @ b.T)[:, :, None] * decay * d[None, :, :]     # (i, j, H)
        y = torch.einsum("ijh,jhp->ihp", w, xs)
        y = y + torch.einsum("in,hpn,ih->ihp", c, h, torch.exp(cs))
        ys.append(y)
        last = torch.exp(cs[-1][None, :] - cs)                # (j, H)
        h = h * torch.exp(cs[-1])[:, None, None] + torch.einsum(
            "jh,jhp,jn->hpn", last * d, xs, b)
    return torch.cat(ys)


def mixer(h: torch.Tensor, lw: Dict, m: Dict, mm: MM) -> torch.Tensor:
    L = h.shape[0]
    di = m["ssm_expand"] * m["d_model"]
    N, P = m["ssm_state"], m["ssm_headdim"]
    H = di // P
    zxbcdt = mm(h, lw["in_proj"])
    z, xbc, dtl = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N], \
        zxbcdt[:, 2 * di + 2 * N:]
    padded = F.pad(xbc, (0, 0, CONV_WIDTH - 1, 0))
    conv = sum(padded[i:i + L] * lw["conv_w"][i] for i in range(CONV_WIDTH))
    xbc = F.silu(conv + lw["conv_b"])
    xs, Bm, Cm = xbc[:, :di], xbc[:, di:di + N], xbc[:, di + N:]
    dt = F.softplus(dtl + lw["dt_bias"])
    A = -torch.exp(lw["A_log"])
    y = ssd(xs.view(L, H, P), dt, A, Bm, Cm)
    y = (y + lw["D"][:, None] * xs.view(L, H, P)).reshape(L, di)
    y = y * F.silu(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-6) \
        * lw["gate_norm"]
    return mm(y, lw["out_proj"])


@torch.no_grad()
def forward(w: Dict, m: Dict, seqs: List[torch.Tensor], firsts: List[int],
            mm: MM) -> List[torch.Tensor]:
    """Float32 logits of each token sequence in ``seqs`` (1-D, on the
    weights' device) at its positions ``first`` and after."""
    xs = embed(w, seqs)
    n, k = m["num_layers"], m["attn_every"]
    for lo in range(0, n, k):
        for i in range(lo, min(lo + k, n)):
            lw = sub(w, f"layers.{i}.mixer")
            xs = [x + mixer(norm(x, w, f"layers.{i}.norm", m), lw, m, mm)
                  for x in xs]
        xs = block(xs, w, "shared_attn", m, mm)
    return head(w, xs, firsts, m, mm)
