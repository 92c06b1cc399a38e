"""Mamba2 (SSD, state-space duality) mixer (port of ``repro.models.ssm``).

Prefill runs the chunked SSD algorithm of arXiv:2405.21060: quadratic,
attention-like products within each chunk (``torch.einsum``) and the
linear recurrence of chunk states across chunks, which goes through
``kernels.ops.ssd_state_scan``: the CUDA kernel K3 for CUDA tensors,
its plain version for CPU ones.  Decode is the O(1) recurrent step over
a (conv, ssm-state) cache::

    {"conv": (B, CONV_WIDTH - 1, d_inner + 2N) model dtype,
     "ssm":  (B, H, P, N) fp32}

Shapes: x (B, L, H, P) with H = d_inner / headdim heads; the B and C
projections are shared across heads (one group, as in Mamba2); state
size N.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.dist.sharding import is_placed, shard
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init_, model_dtype, param

CONV_WIDTH = 4


class SSM(nn.Module):
    """``in_proj`` (d, 2di+2N+H) ordered [z, x, B, C, dt], ``conv_w``
    (CONV_WIDTH, di+2N), ``conv_b``, ``out_proj`` (di, d) in the model
    dtype; ``A_log``, ``D``, ``dt_bias`` (H,) and ``gate_norm`` (di,) in
    fp32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt, f32 = model_dtype(cfg), torch.float32
        d, di, N, H = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                       cfg.ssm_nheads)
        conv_ch = di + 2 * N
        self.in_proj = param((d, 2 * di + 2 * N + H), dt, device,
                             ("embed", "ssm_inner"))
        self.conv_w = param((CONV_WIDTH, conv_ch), dt, device,
                            ("conv", "ssm_inner"))
        self.conv_b = param((conv_ch,), dt, device, ("ssm_inner",))
        self.A_log = param((H,), f32, device, ("ssm_heads",))
        self.D = param((H,), f32, device, ("ssm_heads",))
        self.dt_bias = param((H,), f32, device, ("ssm_heads",))
        self.gate_norm = param((di,), f32, device, ("ssm_inner",))
        self.out_proj = param((di, d), dt, device, ("ssm_inner", "embed"))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: A = -(1..H), dt drawn log-uniform in
        [0.001, 0.1] and stored as its inverse softplus, conv weights
        normal * 0.2."""
        f32, dev = torch.float32, self.A_log.device
        H = self.A_log.shape[0]
        dense_init_(self.in_proj, generator)
        dense_init_(self.out_proj, generator)
        u = torch.rand((H,), generator=generator, device=dev, dtype=f32)
        dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                            + math.log(0.001))
        self.dt_bias.copy_(dt_init + torch.log(-torch.expm1(-dt_init)))
        w = torch.randn(self.conv_w.shape, generator=generator, device=dev,
                        dtype=f32)
        self.conv_w.copy_(w.to(self.conv_w.dtype) * 0.2)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.arange(1, H + 1, dtype=f32,
                                                device=dev)))
        self.D.fill_(1.0)
        self.gate_norm.fill_(1.0)


def init_ssm_cache(cfg: ModelConfig, batch: int, *, layers: int = 0,
                   device=None) -> Dict:
    """Zero cache; with ``layers`` > 0 every leaf gains a leading layer
    axis (the model's stacked cache)."""
    di, N, H, Pd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_headdim)
    lead = (layers,) if layers else ()
    return {
        "conv": torch.zeros(lead + (batch, CONV_WIDTH - 1, di + 2 * N),
                            dtype=model_dtype(cfg), device=device),
        "ssm": torch.zeros(lead + (batch, H, Pd, N), dtype=torch.float32,
                           device=device),
    }


def ssm_cache_logical_axes(cfg: ModelConfig) -> Dict:
    return {"conv": ("batch", None, "ssm_inner"),
            "ssm": ("batch", "ssm_heads", None, "state")}


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------

def _segsum(a):
    """a: (..., cl, h) -> (..., h, cl, cl) lower-triangular segment sums
    (-inf above the diagonal)."""
    cl = a.shape[-2]
    cs = torch.cumsum(a.movedim(-1, -2), dim=-1)           # (..., h, cl)
    seg = cs[..., :, None] - cs[..., None, :]              # sum_(j..i]
    mask = torch.tril(torch.ones(cl, cl, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD.

    x: (b, l, h, p) fp32; dt: (b, l, h) fp32 (post-softplus);
    A: (h,) fp32 (negative); Bm/Cm: (b, l, n) fp32.
    Returns y (b, l, h, p), final_state (b, h, p, n).  The cross-chunk
    recurrence always goes through ``ops.ssd_state_scan``, so CUDA
    tensors always run K3 (the reference's ``use_kernel`` switch picks
    between two versions of the same function and has no counterpart).
    """
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-l) % chunk
    if pad:   # zero-pad the sequence axis (1) to a chunk multiple
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    L = x.shape[1]
    c = L // chunk
    xr = x.reshape(b, c, chunk, h, p)
    dtr = dt.reshape(b, c, chunk, h)
    Br = Bm.reshape(b, c, chunk, n)
    Cr = Cm.reshape(b, c, chunk, n)

    dA = dtr * A                                           # (b,c,cl,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # ---- intra-chunk (quadratic within chunk) -------------------------------
    Lmat = torch.exp(_segsum(dA))                          # (b,c,h,cl,cl)
    G = torch.einsum("bczn,bcln->bczl", Cr, Br)            # (b,c,cl_q,cl_k)
    M = G[:, :, None] * Lmat                               # (b,c,h,z,l)
    y_diag = torch.einsum("bchzl,bclh,bclhp->bczhp", M, dtr, xr)

    # ---- chunk states -------------------------------------------------------
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,c,cl,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn",
                          Br, decay_states * dtr, xr)      # (b,c,h,p,n)

    # ---- inter-chunk recurrence (K3) ----------------------------------------
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (b,c,h)
    s0 = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state)
    prev_states, final = ops.ssd_state_scan(states, chunk_decay, s0)

    # ---- chunk-start contribution -------------------------------------------
    state_decay = torch.exp(dA_cs)                         # (b,c,cl,h)
    y_off = torch.einsum("bczn,bchpn,bczh->bczhp", Cr, prev_states,
                         state_decay)

    y = (y_diag + y_off).reshape(b, L, h, p)[:, :l]
    return y, final


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """One recurrent step.  state: (b,h,p,n); x_t: (b,h,p); dt_t: (b,h);
    B_t/C_t: (b,n).  Returns (new_state, y_t)."""
    dA = torch.exp(dt_t * A)                               # (b,h)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt_t, B_t, x_t)
    new_state = state * dA[:, :, None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t)
    return new_state, y


# --------------------------------------------------------------------------
# Full mixer (in_proj -> conv -> SSD -> gate -> out_proj)
# --------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, zxbcdt):
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xc = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xc, dt


def _by_block(blocks, parts: int):
    """want(j) for :func:`sharding.take`: chunk j of each (lo, hi) block,
    as the block alone would be split over ``parts`` devices."""
    def want(j):
        return [tuple(lo + c for c in sharding.chunk(hi - lo, parts, j))
                for lo, hi in blocks]
    return want


def _resplit(t, dim: int, blocks):
    """``t``, placed with ``dim`` split over one mesh axis in chunks that
    cut across ``blocks``, as one DTensor a block, each split alike over
    that axis: one all-to-all (``sharding.take``), differentiable."""
    mesh, pl = t.device_mesh, tuple(t.placements)
    a = pl.index(Shard(dim))
    parts, me = mesh.size(a), mesh.get_coordinate()[a]
    want = _by_block(blocks, parts)
    pieces = sharding.take(t, dim, want, "ssm re-split").split(
        [hi - lo for lo, hi in want(me)], dim)
    shape = tuple(t.shape)
    return [sharding.from_pieces(
        p, mesh, pl, shape[:dim] + (hi - lo,) + shape[dim + 1:])
        for p, (lo, hi) in zip(pieces, blocks)]


def _placed_in_proj(params: SSM, x, cfg: ModelConfig):
    """Placed prefill's (z, xc, dt) and conv.  in_proj's product is split
    over ``ssm_inner`` (the reference's constraint) in chunks that cut
    across its column blocks z, x, B|C and dt; one all-to-all re-splits
    it block by block (dt as the heads), GSPMD's collective-permute,
    where slicing the product, or in_proj, would gather it whole.  The
    conv's weights are re-split by the same blocks, and x's and B|C's
    convs run apart on their shards.  Returns (z, xc after the conv, dt,
    the product)."""
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    proj = shard(x @ params.in_proj, "batch", "seq", "ssm_inner")
    z, xp, bc, dt = _resplit(
        proj, 2, ((0, di), (di, 2 * di), (2 * di, 2 * di + 2 * N),
                  (2 * di + 2 * N, proj.shape[2])))
    conv = ((0, di), (di, di + 2 * N))
    cw = _resplit(params.conv_w, 1, conv)
    cb = _resplit(params.conv_b, 0, conv)
    xs = _causal_conv(xp, cw[0], cb[0])
    bcs = _causal_conv(bc, cw[1], cb[1])
    return z, (xs, bcs), dt, proj


def _placed_bc(bcs, N: int):
    """B and C (fp32) from the placed conv's output ``bcs`` (B, L, 2N),
    its channels split: whole on every device (all-gathered), as the
    SSD's products over the heads take them, their gradients (partial
    sums over the heads) all-reduced: GSPMD's collectives for them,
    asked for rather than left to DTensor's slicing."""
    bcs = shard(bcs, "batch", "seq", None)
    return bcs[..., :N].float(), bcs[..., N:].float()


def _placed_conv_cache(proj, cfg: ModelConfig):
    """The prefill's conv cache, placed as ``ssm_cache_logical_axes``
    says, from in_proj's product (``_placed_in_proj``): its last
    ``CONV_WIDTH - 1`` rows of the conv's columns [x | B | C], which one
    all-to-all re-splits as the cache's channels (left-padded with zeros
    locally when the prompt is shorter).  No device holds the (B, L, .)
    conv input whole."""
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    B, L, _ = proj.shape
    mesh, pl = proj.device_mesh, tuple(proj.placements)
    parts = mesh.size(pl.index(Shard(2)))
    local = sharding.take(proj[:, max(L - (CONV_WIDTH - 1), 0):], 2,
                          _by_block(((di, 2 * di + 2 * N),), parts),
                          "ssm conv cache")
    if L < CONV_WIDTH - 1:
        local = F.pad(local, (0, 0, CONV_WIDTH - 1 - L, 0))
    return sharding.from_pieces(local, mesh, pl,
                                (B, CONV_WIDTH - 1, di + 2 * N))


def _silu(x):
    """``jax.nn.silu`` op for op: x * 1 / (1 + exp(-x)), each op rounded
    to x's dtype.  In bf16, ``F.silu``'s single rounding differs from it
    in about a third of the elements, which over a deep stack moves the
    logits by several bf16 ulps."""
    return x * (1 / (1 + torch.exp(-x)))


def _conv(xp, w, b):
    """Depthwise conv in xp's dtype: output t sees xp[:, t:t+W].
    xp: (B, L+W-1, C); w: (W, C)."""
    W = w.shape[0]
    L = xp.shape[1] - W + 1
    out = sum(xp[:, i:i + L, :] * w[i] for i in range(W))
    return _silu(out + b)


def _causal_conv(xc, w, b):
    """Depthwise causal conv in the input dtype.  xc: (B, L, C); w: (W, C).
    Placed, on each device's shards (batch, channels): it is local."""
    def conv(xc, w, b):
        return _conv(F.pad(xc, (0, 0, w.shape[0] - 1, 0)), w, b)

    if not sharding.is_placed(xc):
        return conv(xc, w, b)
    return sharding.on_shards("causal_conv", conv, xc, (xc, w, b),
                              ((0, 2), (None, 1), (None, 0)), ((0, 2),))


def _gated_out(cfg: ModelConfig, params: SSM, y, z, x_conv):
    y = y + params.D[:, None] * x_conv.reshape(y.shape)
    yf = y.reshape(*y.shape[:-2], cfg.ssm_d_inner)
    yf = yf * F.silu(z.float())
    # placed, the channels split: the mean's partial sums, and the
    # gradient of the scale the channels share, all-reduced as GSPMD does
    ms = sharding.reduced(yf.square().mean(-1, keepdim=True))
    # the reference's gate-norm eps is 1e-6 whatever cfg.norm_eps says
    yf = yf * sharding.reduced_grad(torch.rsqrt(ms + 1e-6)) * params.gate_norm
    return yf.to(model_dtype(cfg)) @ params.out_proj


def ssm_forward(params: SSM, x, cfg: ModelConfig,
                initial_state: Optional[Dict] = None,
                return_cache: bool = False):
    """x: (B, L, D) -> (y, cache or None).  Full sequence (prefill)."""
    Bsz, L, _ = x.shape
    di, N, H, Pd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_headdim)
    # placed where x is: reading a parameter split over a batch axis
    # gathers it (FSDP), so the test reads none
    if is_placed(x):
        z, (xs, bcs), dtl, proj = _placed_in_proj(params, x, cfg)
        xs, (Bm, Cm) = xs.float(), _placed_bc(bcs, N)
    else:
        zxbcdt = x @ params.in_proj
        z, xc, dtl = _split_proj(cfg, zxbcdt)
        xc = shard(xc, "batch", "seq", "ssm_inner")
        pre = xc
        xc = _causal_conv(xc, params.conv_w, params.conv_b)
        xs = xc[..., :di].float()
        Bm = xc[..., di:di + N].float()
        Cm = xc[..., di + N:].float()
    dt = F.softplus(dtl.float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    xh = shard(xs.reshape(Bsz, L, H, Pd), "batch", "seq", "ssm_heads", None)
    args = (xh, dt, A, Bm, Cm) + (() if initial_state is None
                                  else (initial_state["ssm"],))

    def scan(x, dt, A, Bm, Cm, s0=None):
        return ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk, initial_state=s0)

    if is_placed(xh):   # local over the batch and the heads: on the shards
        y, final = sharding.on_shards(
            "ssd_chunked", scan, xh, args,
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None),
             (0, 1))[:len(args)], ((0, 2), (0, 1)))
    else:
        y, final = scan(*args)
    out = shard(_gated_out(cfg, params, y, z, xs), "batch", "seq", "embed_act")
    if not return_cache:
        return out, None
    # conv cache = the last (W-1) *pre-activation* conv inputs, left-padded
    # with zeros when the prompt is shorter
    if is_placed(x):
        conv_cache = _placed_conv_cache(proj, cfg)
    elif L >= CONV_WIDTH - 1:
        conv_cache = pre[:, -(CONV_WIDTH - 1):, :]
    else:
        conv_cache = F.pad(pre, (0, 0, CONV_WIDTH - 1 - L, 0))
    return out, {"conv": conv_cache.to(model_dtype(cfg)), "ssm": final}


def _decode_conv(window, xc_new, w, b):
    """The conv over [the cached window, the new token], in fp32 as the
    reference's decode runs it, and the window to keep.  Local over the
    batch and the channels."""
    window = torch.cat([window, xc_new.to(window.dtype)], dim=1)  # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return _silu(out + b.float()), window[:, 1:]


def _placed_decode_inputs(params: SSM, x, cfg: ModelConfig, cache: Dict):
    """Placed decode's (z, dt's logits, x by heads, B, C, the conv window
    to keep).  in_proj's product is split over ``ssm_inner`` in chunks
    that cut across its blocks [z, x|B|C, dt]; one all-to-all re-splits
    it block by block (z and the conv's channels as the conv cache and
    weights are split, dt as the heads), GSPMD's collective-permute,
    where slicing the product would gather it whole.  The conv runs on
    the shards of its channels; its output is re-split once more: x by
    heads, B and C whole on every device."""
    di, N, H, Pd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_headdim)
    B = x.shape[0]
    # (B, 1, 2di+2N+H), a partial sum reduced first (the residual stream
    # a placed decode hands on may hold one)
    proj = shard(x @ params.in_proj, "batch", None, "ssm_inner")
    mesh, pl = proj.device_mesh, tuple(proj.placements)
    a = pl.index(Shard(2))          # the mesh axis splitting the columns
    parts, me = mesh.size(a), mesh.get_coordinate()[a]
    z, xc_new, dtl = _resplit(
        proj, 2, ((0, di), (di, 2 * di + 2 * N),
                  (2 * di + 2 * N, proj.shape[2])))

    conv_out, window = sharding.on_shards(
        "decode_conv", _decode_conv, cache["conv"],
        (cache["conv"], xc_new, params.conv_w, params.conv_b),
        ((0, 2), (0, 2), (None, 1), (None, 0)), ((0, 1), (0, 2)),
        strict=True)

    def heads_and_bc(j):
        lo, hi = sharding.chunk(H, parts, j)
        return [(lo * Pd, hi * Pd), (di, di + 2 * N)]

    lo, hi = sharding.chunk(H, parts, me)
    xs, bc = sharding.take(conv_out, 1, heads_and_bc, "ssm decode").split(
        [(hi - lo) * Pd, 2 * N], 1)
    xs = sharding.from_pieces(
        xs.view(xs.shape[0], hi - lo, Pd), mesh,
        [Shard(1) if i == a else p for i, p in enumerate(pl)], (B, H, Pd))
    bc = sharding.from_pieces(
        bc, mesh, [Replicate() if i == a else p for i, p in enumerate(pl)],
        (B, 2 * N))
    return z, dtl, xs, bc[:, :N], bc[:, N:], window


def ssm_decode(params: SSM, x, cfg: ModelConfig, cache: Dict):
    """x: (B, 1, D).  Writes the shifted conv window and the new state
    into ``cache`` in place (the reference builds a new cache) and
    returns ``(y, cache)``.  The conv over the window is computed in
    fp32, as the reference's decode does (its prefill conv runs in the
    model dtype).
    """
    Bsz = x.shape[0]
    di, N, H, Pd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_headdim)
    if is_placed(params.in_proj):
        z, dtl, xs, Bm, Cm, window = _placed_decode_inputs(params, x, cfg,
                                                           cache)
    else:
        z, xc_new, dtl = _split_proj(cfg, x @ params.in_proj)
        conv_out, window = _decode_conv(cache["conv"], xc_new,
                                        params.conv_w, params.conv_b)
        xs = conv_out[:, :di].reshape(Bsz, H, Pd)
        Bm = conv_out[:, di:di + N]
        Cm = conv_out[:, di + N:]
    dt = F.softplus(dtl[:, 0].float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    new_state, y = ssd_step(cache["ssm"], xs, dt, A, Bm, Cm)
    out = _gated_out(cfg, params, y.reshape(Bsz, 1, H, Pd), z, xs)
    cache["conv"].copy_(window)
    cache["ssm"].copy_(new_state)
    return out, cache
