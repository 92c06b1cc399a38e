"""Public kernel ops: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

Counterpart of ``repro.kernels.ops``.  A CUDA tensor always launches
the kernel (which raises on what it cannot take); it never falls back
to the plain version.  A CPU tensor takes the plain version in
``ref``, since the kernels exist only for the card.  Each kernel
module's ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

from repro_torch.kernels import arma_fit as _arma
from repro_torch.kernels import bucket_step as _bucket
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, q_pos, k_pos, *, scale: float,
                    causal: bool = True, window: int = 0):
    """q: (B,H,S,hd); k/v: (B,Hkv,T,hd); q_pos: (B,S); k_pos: (B,T)."""
    fn = _fa.flash_attention if q.is_cuda else ref.flash_attention_ref
    return fn(q, k, v, q_pos, k_pos, scale=scale, causal=causal,
              window=window)


def decode_attention(q, k, v, k_pos, cur_pos, *, scale: float,
                     window: int = 0):
    """q: (B,H,hd); k/v: (B,Hkv,T,hd); k_pos: (B,T); cur_pos: (B,)."""
    fn = _dec.decode_attention if q.is_cuda else ref.decode_attention_ref
    return fn(q, k, v, k_pos, cur_pos, scale=scale, window=window)


def ssd_state_scan(states, decay, s0):
    """states: (b,c,h,p,n); decay: (b,c,h); s0: (b,h,p,n); all fp32."""
    fn = _ssd.ssd_state_scan if states.is_cuda else ref.ssd_state_scan_ref
    return fn(states, decay, s0)


def arma_fit(y, init, p: int, q: int, steps: int, lr: float):
    """y: (S, L); init: (S, p+1+q) packed (c, phi, theta); both fp32."""
    if y.is_cuda:
        return _arma.arma_fit(y, init, p, q, steps, lr)
    _arma.check_args(y, init, p, q, steps)
    return ref.arma_fit_ref(y, init, p, q, steps, lr)


def bucket_segment(layout, consts, prm, carry, xs, b0: int, b1: int):
    """Buckets b0..b1-1 of the vector engine for R replicas: consts (NC,),
    prm (R, K), carry (R, F), xs (S, X), all fp32 packed as ``layout``
    (``ref.BucketLayout``).  Returns (carry (R, F), ys (R, b1-b0, Y))."""
    if carry.is_cuda:
        return _bucket.bucket_segment(layout, consts, prm, carry, xs, b0, b1)
    _bucket.check_args(layout, consts, prm, carry, xs, b0, b1)
    return ref.bucket_segment_ref(layout, consts, prm, carry, xs, b0, b1)
