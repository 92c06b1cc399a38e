"""Flash-decode attention: wrapper of the CUDA kernel ``csrc/decode_attention.cu``.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_decode_kernel``).  The kernel takes the reference's public layout,
q (B,H,hd), k/v (B,Hkv,T,hd), k_pos (B,T), cur_pos (B,), through
strides, so the model hands it a transposed view of its (B,W,Hkv,hd)
cache without a copy; any T works.  It splits the cache axis across
blocks and merges the chunks in a second pass; this wrapper chooses the
number of chunks and allocates their partial results.  It only
launches: it raises for tensors that are not on a CUDA device.
``ops.decode_attention`` picks between it and the plain version in
``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 112, 128, 160, 256)
MAX_GROUP = 16     # GMAX in the source: query heads per kv head
TILE = 64          # DBK in the source: cache slots per tile


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
        _build.INT64_PTR, _build.INT64_PTR, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def split_plan(B: int, Hkv: int, T: int, num_sms: int):
    """(nsplit, chunk): chunks of the cache axis so that B*Hkv*nsplit
    blocks number about four per SM of ``num_sms``; chunk is a multiple
    of the tile and nsplit chunks cover T.  More chunks hide more
    latency but write more partial results for the combine pass."""
    tiles = -(-T // TILE)
    want = max(1, min(tiles, -(-4 * num_sms // max(1, B * Hkv))))
    chunk = -(-tiles // want) * TILE
    return -(-T // chunk), chunk


def decode_attention(q, k, v, k_pos, cur_pos, *, scale: float,
                     window: int = 0):
    """q: (B,H,hd); k/v: (B,Hkv,T,hd); k_pos: (B,T); cur_pos: (B,).

    Returns (B,H,hd) in ``q.dtype``.
    """
    global LAUNCHES
    _build.check_qkv("decode_attention", HEAD_DIMS, q=q, k=k, v=v)
    B, H, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if H % Hkv or H // Hkv > MAX_GROUP or k.shape[0] != B \
            or v.shape[:3] != k.shape[:3] or T == 0:
        raise ValueError(f"decode_attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (GQA "
                         f"group at most {MAX_GROUP}, T > 0)")
    dev = q.device
    g = H // Hkv
    k_pos = k_pos.to(device=dev, dtype=torch.int32).expand(B, T)
    cur_pos = cur_pos.to(device=dev, dtype=torch.int32).expand(B)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    nsplit, chunk = split_plan(
        B, Hkv, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    m_part = torch.empty((B, Hkv, nsplit, g), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, Hkv, nsplit, g, hd), dtype=torch.float32,
                           device=dev)
    dims = _build.int64s((B, H, Hkv, T, hd, nsplit, chunk))
    strides = _build.int64s((*q.stride()[:2], *k.stride()[:3],
                             *v.stride()[:3], *out.stride()[:2],
                             *k_pos.stride(), *cur_pos.stride()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(_build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), k_pos.data_ptr(), cur_pos.data_ptr(),
                    out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                    acc_part.data_ptr(), dims, strides, float(scale),
                    int(window), stream)
    _build.check(err, "decode_attention_fwd")
    LAUNCHES += 1
    return out
