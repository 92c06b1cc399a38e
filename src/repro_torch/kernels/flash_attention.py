"""Prefill flash attention: wrapper of the CUDA kernel ``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_kernel``).  The kernel takes the reference's public layout,
q (B,H,S,hd), k/v (B,Hkv,T,hd), q_pos (B,S), k_pos (B,T), through
strides, so the model hands it transposed views of its (B,S,H,hd)
activations without a copy; any S and T work (no block divisibility).
bf16 inputs go through the wgmma kernel, whose TMA tensor maps describe
those views in place: their base addresses and strides must be 16-byte
aligned, and this wrapper raises (through ``_build.check_qkv``) on any
that is not.  This wrapper only launches: it raises for tensors that
are not on a CUDA device.  ``ops.flash_attention`` picks between it and
the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 112, 128, 160, 192, 256)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        _build.INT64_PTR, _build.INT64_PTR, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, q_pos, k_pos, *, scale: float,
                    causal: bool = True, window: int = 0):
    """q: (B,H,S,hd); k/v: (B,Hkv,T,hd); q_pos: (B,S); k_pos: (B,T).

    Returns (B,H,S,hd) in ``q.dtype``: a transposed view of a
    (B,S,H,hd) buffer, so ``.transpose(1, 2)`` of it is contiguous.
    """
    global LAUNCHES
    _build.check_qkv("flash_attention", HEAD_DIMS, q=q, k=k, v=v)
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if H % Hkv or k.shape[0] != B or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    dev = q.device
    q_pos = q_pos.to(device=dev, dtype=torch.int32).expand(B, S)
    k_pos = k_pos.to(device=dev, dtype=torch.int32).expand(B, T)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    out = out.transpose(1, 2)
    if B == 0 or S == 0:
        return out
    if T == 0:
        raise ValueError("flash_attention kernel: no keys (T == 0)")
    dims = _build.int64s((B, H, Hkv, S, T, hd))
    strides = _build.int64s((*q.stride()[:3], *k.stride()[:3],
                             *v.stride()[:3], *out.stride()[:3],
                             *q_pos.stride(), *k_pos.stride()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(_build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                    out.data_ptr(), dims, strides, float(scale),
                    int(bool(causal)), int(window), stream)
    _build.check(err, "flash_attention_fwd")
    LAUNCHES += 1
    return out
