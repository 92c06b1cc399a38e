"""Public kernel ops: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

Counterpart of ``repro.kernels.ops``.  A CUDA tensor always launches
the kernel (which raises on what it cannot take); it never falls back
to the plain version.  A CPU tensor takes the plain version in
``ref``, since the kernels exist only for the card.  Each kernel
module's ``LAUNCHES`` counts its launches.

Placed tensors (DTensors, ``dist.sharding``) reach K1, K2 and K3 as
their local shards (``sharding.on_shards``, through ``torch.
distributed.tensor.experimental.local_map``), under the placements
where the op is local: a split of the batch or of the heads (K/V split
alike), anything replicated.  K/V split over their sequence (the
long-context decode's ``kv_seq``) are first gathered over that axis, as
GSPMD gathers them for the reference's ``_attend``.  On the card any
other placement raises; on the CPU and on meta tensors (the dry run)
the plain version then runs on the DTensors, which DTensor partitions
itself (a head_dim split: partial scores, then an all-reduce).

``flash_attention`` and ``ssd_state_scan`` are differentiable: each is
a ``torch.autograd.Function`` whose forward runs the kernel (K2, which
then also writes each row's log-sum-exp, or K3) and whose backward
runs its backward kernel (``csrc/flash_attention_bwd.cuh``, the reverse
scan in ``csrc/ssd_scan.cu``), counted in the kernel module's
``BWD_LAUNCHES``; on the CPU both directions take the plain versions
(``ref.flash_attention_bwd_ref``, ``ref.ssd_state_scan_bwd_ref``).  A
call that needs no gradient (serving) runs the forward alone, as
before.

While a profiler records, each call of K1, K2 and K3 sits in a range,
``kernel.k1``, ``kernel.k2`` and ``kernel.k3`` (``tracing.range``): the
kernels launch through ctypes, so a CPU profile shows no operator of
theirs.  Without a profiler the ranges cost one flag read.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.dist import sharding
from repro_torch.kernels import arma_fit as _arma
from repro_torch.kernels import bucket_step as _bucket
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, causal, window):
        opts = dict(scale=scale, causal=causal, window=window)
        grad = any(ctx.needs_input_grad[:3])
        if q.is_cuda:
            out = _fa.flash_attention(q, k, v, q_pos, k_pos,
                                      return_lse=grad, **opts)
        elif grad:
            out = ref.flash_attention_lse_ref(q, k, v, q_pos, k_pos, **opts)
        else:
            out = ref.flash_attention_ref(q, k, v, q_pos, k_pos, **opts)
        if not grad:
            return out
        out, lse = out
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        fn = _fa.flash_attention_bwd if do.is_cuda \
            else ref.flash_attention_bwd_ref
        dq, dk, dv = fn(q, k, v, out, lse, do, q_pos, k_pos, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_pos, k_pos, *, scale: float,
                    causal: bool = True, window: int = 0):
    """q: (B,H,S,hd); k: (B,Hkv,T,hd); v: (B,Hkv,T,hd_v); q_pos: (B,S);
    k_pos: (B,T).  Returns (B,H,S,hd_v)."""
    def run(q, k, v, q_pos, k_pos):
        return _FlashAttention.apply(q, k, v, q_pos, k_pos, scale, causal,
                                     window)

    with tracing.range("kernel.k2"):
        if not sharding.is_placed(q):
            return run(q, k, v, q_pos, k_pos)
        return sharding.on_shards(
            "flash_attention", run, q, (q, k, v, q_pos, k_pos),
            ((0, 1), (0, 1), (0, 1), (0, None), (0, None)), ((0, 1),),
            strict=q.is_cuda)


def decode_attention(q, k, v, k_pos, cur_pos, *, scale: float,
                     window: int = 0):
    """q: (B,H,hd); k/v: (B,Hkv,T,hd); k_pos: (B,T); cur_pos: (B,)."""
    def run(q, k, v, k_pos, cur_pos):
        fn = _dec.decode_attention if q.is_cuda else ref.decode_attention_ref
        return fn(q, k, v, k_pos, cur_pos, scale=scale, window=window)

    with tracing.range("kernel.k1"):
        if not sharding.is_placed(q):
            return run(q, k, v, k_pos, cur_pos)
        return sharding.on_shards(
            "decode_attention", run, q, (q, k, v, k_pos, cur_pos),
            ((0, 1), (0, 1), (0, 1), (0, None), (0, None)), ((0, 1),),
            strict=q.is_cuda)


class _SSDStateScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, states, decay, s0):
        fn = _ssd.ssd_state_scan if states.is_cuda \
            else ref.ssd_state_scan_ref
        prev, final = fn(states, decay, s0)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(decay, prev)
        return prev, final

    @staticmethod
    def backward(ctx, dprev, dfinal):
        decay, prev = ctx.saved_tensors
        fn = _ssd.ssd_state_scan_bwd if prev.is_cuda \
            else ref.ssd_state_scan_bwd_ref
        return fn(decay, prev, dprev, dfinal)


def ssd_state_scan(states, decay, s0):
    """states: (b,c,h,p,n); decay: (b,c,h); s0: (b,h,p,n); all fp32.
    Returns (prev (b,c,h,p,n), final (b,h,p,n))."""
    with tracing.range("kernel.k3"):
        if not sharding.is_placed(states):
            return _SSDStateScan.apply(states, decay, s0)
        return sharding.on_shards(
            "ssd_state_scan", _SSDStateScan.apply, states,
            (states, decay, s0), ((0, 2), (0, 2), (0, 1)),
            ((0, 2), (0, 1)), strict=states.is_cuda)


def arma_fit(y, init, p: int, q: int, steps: int, lr: float):
    """y: (S, L); init: (S, p+1+q) packed (c, phi, theta); both fp32."""
    if y.is_cuda:
        return _arma.arma_fit(y, init, p, q, steps, lr)
    _arma.check_args(y, init, p, q, steps)
    return ref.arma_fit_ref(y, init, p, q, steps, lr)


def bucket_segment(layout, consts, prm, carry, xs, b0: int, b1: int):
    """Buckets b0..b1-1 of the vector engine for R replicas: consts (NC,),
    prm (R, K), carry (R, F), xs (S, X), all fp32 packed as ``layout``
    (``ref.BucketLayout``).  Returns (carry (R, F), ys (R, b1-b0, Y)).

    The carry handoff: both paths write the segment's carry to a fresh
    buffer, never into ``carry``, so while a segment is in flight two
    carries are alive, its input and its output.  A caller that rebinds
    its carry to the output (``VectorBatch.run``) frees the input and
    holds one carry between segments; the trace tier's T4 checks that
    no more stay alive."""
    if carry.is_cuda:
        return _bucket.bucket_segment(layout, consts, prm, carry, xs, b0, b1)
    _bucket.check_args(layout, consts, prm, carry, xs, b0, b1)
    return ref.bucket_segment_ref(layout, consts, prm, carry, xs, b0, b1)
