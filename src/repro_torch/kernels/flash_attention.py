"""Prefill flash attention: wrapper of the CUDA kernel ``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_kernel``).  The kernel takes the reference's public layout,
q (B,H,S,hd), k (B,Hkv,T,hd), v (B,Hkv,T,hd_v), q_pos (B,S), k_pos (B,T),
through strides, so the model hands it transposed views of its
(B,S,H,hd) activations without a copy; any S and T work (no block
divisibility).  V has a head dim of its own: hd_v = hd, or MLA's q/k 192
with V 128 (``HEAD_DIM_PAIRS``); the output is hd_v wide.
bf16 inputs go through the wgmma kernel, whose TMA tensor maps describe
those views in place: their base addresses and strides must be 16-byte
aligned, and this wrapper raises (through ``_build.check_qkv``) on any
that is not.  This wrapper only launches: it raises for tensors that
are not on a CUDA device.  ``ops.flash_attention`` picks between it and
the plain version in ``ref``.

Training: with ``return_lse`` the forward also writes each row's
log-sum-exp, and :func:`flash_attention_bwd` launches the backward
kernels on it, built as ``flash_attention_bwd_f32.cu`` and
``flash_attention_bwd_bf16.cu``, one library per input type: bf16 at
every head dim runs on the tensor cores
(``csrc/flash_attention_bwd_wgmma.cuh``), fp32 on the scalar kernels of
``csrc/flash_attention_bwd.cuh`` (:func:`bwd_route` says which).  ``ops``
wraps both directions in a ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0
#: launches of the backward kernel since the count was last set to 0
BWD_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 96, 112, 128, 160, 192, 256)
#: the (hd, hd_v) pairs the kernels take: V at q/k's head dim, and MLA's
#: q/k 192 (nope 128 + rope 64) with V 128
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        _build.INT64_PTR, _build.INT64_PTR, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_lib(dtype: torch.dtype):
    """The backward's library for ``dtype``: its entry point, the scratch
    it needs and the route it takes per head dim."""
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    lib = _build.load(f"flash_attention_bwd_{name}")
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        _build.INT64_PTR, _build.INT64_PTR, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_scratch.argtypes = [ctypes.c_int,
                                                _build.INT64_PTR]
    lib.flash_attention_bwd_scratch.restype = ctypes.c_longlong
    lib.flash_attention_bwd_route.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_bwd_route.restype = ctypes.c_int
    return lib


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """Which backward kernels take ``dtype`` at head dim ``hd``: "wgmma"
    (the tensor cores, bf16) or "fma" (the scalar kernels, fp32)."""
    route = _bwd_lib(dtype).flash_attention_bwd_route(_build.DTYPES[dtype],
                                                      hd)
    return "wgmma" if route == 1 else "fma"


def _check_shapes(q, k, v):
    _build.check_qkv("flash_attention", HEAD_DIM_PAIRS, dict(q=q, k=k),
                     dict(v=v))
    B, H = q.shape[:2]
    Hkv = k.shape[1]
    if H % Hkv or k.shape[0] != B or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def _positions(pos, B, n, dev):
    return pos.to(device=dev, dtype=torch.int32).expand(B, n)


def flash_attention(q, k, v, q_pos, k_pos, *, scale: float,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (B,H,S,hd); k: (B,Hkv,T,hd); v: (B,Hkv,T,hd_v); q_pos: (B,S);
    k_pos: (B,T).

    Returns (B,H,S,hd_v) in ``q.dtype``: a transposed view of a
    (B,S,H,hd_v) buffer, so ``.transpose(1, 2)`` of it is contiguous.
    With ``return_lse``, also each row's log-sum-exp (B,H,S) fp32, in
    natural-log units of the scaled scores (``NEG_INF`` for a row that
    keeps no key).
    """
    global LAUNCHES
    _check_shapes(q, k, v)
    B, H, S, hd = q.shape
    Hkv, T, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    q_pos = _positions(q_pos, B, S, dev)
    k_pos = _positions(k_pos, B, T, dev)
    out = torch.empty((B, S, H, hd_v), dtype=q.dtype, device=dev)
    out = out.transpose(1, 2)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if return_lse else None)
    if B == 0 or S == 0:
        return (out, lse) if return_lse else out
    if T == 0:
        raise ValueError("flash_attention kernel: no keys (T == 0)")
    dims = _build.int64s((B, H, Hkv, S, T, hd, hd_v))
    strides = _build.int64s((*q.stride()[:3], *k.stride()[:3],
                             *v.stride()[:3], *out.stride()[:3],
                             *q_pos.stride(), *k_pos.stride()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(_build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                    out.data_ptr(), None if lse is None else lse.data_ptr(),
                    dims, strides, float(scale), int(bool(causal)),
                    int(window), stream)
    _build.check(err, "flash_attention_fwd")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, q_pos, k_pos, *, scale: float,
                        causal: bool = True, window: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention``'s output ``o``
    (B,H,S,hd_v) given its gradient ``do`` (B,H,S,hd_v) and the forward's
    ``lse``.

    dq is a transposed view of a (B,S,H,hd) buffer, dk of a (B,T,Hkv,hd)
    one and dv of a (B,T,Hkv,hd_v) one, each in its input's dtype.
    ``do`` may have any strides: it is copied when its head dimension is
    not unit-stride with 16-byte aligned rows, which the kernel reads.
    """
    global BWD_LAUNCHES
    _check_shapes(q, k, v)
    B, H, S, hd = q.shape
    Hkv, T, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if do.shape != (B, H, S, hd_v) or o.shape != do.shape:
        raise ValueError(f"flash_attention_bwd kernel: q {tuple(q.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, "
                         f"do {tuple(do.shape)}")
    do = do.to(q.dtype)
    if not _build.rows_aligned(do):
        do = do.contiguous()
    _build.check_qkv("flash_attention_bwd", HEAD_DIM_PAIRS,
                     dict(q=q, k=k), dict(v=v, o=o, do=do))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd kernel: lse must be a "
                         "contiguous (B,H,S) float32 tensor on q's device")
    dev = q.device
    q_pos = _positions(q_pos, B, S, dev)
    k_pos = _positions(k_pos, B, T, dev)
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((B, T, Hkv, hd), dtype=k.dtype,
                     device=dev).transpose(1, 2)
    dv = torch.empty((B, T, Hkv, hd_v), dtype=v.dtype,
                     device=dev).transpose(1, 2)
    if B == 0 or S == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dims = _build.int64s((B, H, Hkv, S, T, hd, hd_v))
    lib = _bwd_lib(q.dtype)
    code = _build.DTYPES[q.dtype]
    scratch = torch.empty(lib.flash_attention_bwd_scratch(code, dims),
                          dtype=torch.uint8, device=dev)
    strides = _build.int64s(
        (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
         *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
         *dk.stride()[:3], *dv.stride()[:3], *q_pos.stride(),
         *k_pos.stride()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_bwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dims, strides, float(scale), int(bool(causal)),
            int(window), stream)
    _build.check(err, "flash_attention_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv
