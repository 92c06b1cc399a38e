"""SSD cross-chunk state scan: wrapper of the CUDA kernel ``csrc/ssd_scan.cu``.

Port of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_scan_kernel``).  The kernel takes the reference's public layout,
states (b,c,h,p,n), decay (b,c,h), s0 (b,h,p,n), all fp32, through
strides, so the model hands it its einsum output and a strided view of
the chunk decays without the Pallas wrapper's transposes.  Each (p, n)
row must be unit-stride along n, with n a multiple of 4 and rows on
16-byte boundaries.  This wrapper only launches: it raises for tensors
that are not on a CUDA device.  ``ops.ssd_state_scan`` picks between it
and the plain version in ``ref``.  :func:`ssd_state_scan_bwd` launches
the reverse recurrence, the backward that ``ops`` wraps with the forward
in a ``torch.autograd.Function``.
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
#: (p, n) elements of one (b, h) tile the backward's block holds at most
BWD_MAX_TILE = 16 * 4 * 256


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [_build.INT64_PTR,
                                           _build.INT64_PTR, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.load("ssd_scan").ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [_build.INT64_PTR,
                                           _build.INT64_PTR, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows_ok(t, n) -> bool:
    """Whether ``t``'s state axis n is unit-stride, a multiple of 4, with
    16-byte aligned rows (the kernels read it as float4s)."""
    return n % 4 == 0 and t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
        and not any(st % 4 for size, st in zip(t.shape[:-1], t.stride())
                    if size > 1)


def _state_rows(name, t, n) -> None:
    if not _rows_ok(t, n):
        raise ValueError(f"ssd_scan kernel: {name} must have a "
                         f"unit-stride state axis n (a multiple of 4) "
                         f"and 16-byte aligned rows (shape "
                         f"{tuple(t.shape)}, strides {t.stride()})")


def _check(states, decay, s0) -> None:
    b, c, h, p, n = states.shape
    for name, t in (("states", states), ("decay", decay), ("s0", s0)):
        if not t.is_cuda or t.device != states.device:
            raise ValueError(f"ssd_scan kernel: {name} is on {t.device}, not "
                             f"the CUDA device of states")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan kernel: {name} has dtype {t.dtype}, "
                             f"not float32")
    if tuple(decay.shape) != (b, c, h) or tuple(s0.shape) != (b, h, p, n):
        raise ValueError(f"ssd_scan kernel: states {tuple(states.shape)}, "
                         f"decay {tuple(decay.shape)}, s0 {tuple(s0.shape)}")
    for name, t in (("states", states), ("s0", s0)):
        _state_rows(name, t, n)


def ssd_state_scan(states, decay, s0):
    """states: (b,c,h,p,n); decay: (b,c,h); s0: (b,h,p,n), all fp32.

    Returns (prev (b,c,h,p,n), the state entering each chunk, and final
    (b,h,p,n)), both contiguous fp32.
    """
    global LAUNCHES
    _check(states, decay, s0)
    b, c, h, p, n = states.shape
    dev = states.device
    prev = torch.empty((b, c, h, p, n), dtype=torch.float32, device=dev)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if final.numel() == 0:
        return prev, final
    dims = _build.int64s((b, c, h, p, n))
    strides = _build.int64s((*states.stride()[:4], *decay.stride(),
                             *s0.stride()[:3], *prev.stride()[:4],
                             *final.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(states.data_ptr(), decay.data_ptr(), s0.data_ptr(),
                    prev.data_ptr(), final.data_ptr(), dims, strides, stream)
    _build.check(err, "ssd_scan_fwd")
    LAUNCHES += 1
    return prev, final


def ssd_state_scan_bwd(decay, prev, dprev, dfinal):
    """The reverse recurrence: given decay (b,c,h), the forward's prev
    (b,c,h,p,n) and the gradients dprev (b,c,h,p,n) and dfinal
    (b,h,p,n), all fp32 on one CUDA device, returns (dstates
    (b,c,h,p,n), ddecay (b,c,h), ds0 (b,h,p,n)), contiguous.  dprev and
    dfinal are copied when their state axis is not unit-stride with
    16-byte aligned rows."""
    global BWD_LAUNCHES
    b, c, h, p, n = prev.shape
    for name, t in (("decay", decay), ("prev", prev), ("dprev", dprev),
                    ("dfinal", dfinal)):
        if not t.is_cuda or t.device != prev.device:
            raise ValueError(f"ssd_scan_bwd kernel: {name} is on {t.device},"
                             f" not the CUDA device of prev")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan_bwd kernel: {name} has dtype "
                             f"{t.dtype}, not float32")
    if tuple(decay.shape) != (b, c, h) or dprev.shape != prev.shape \
            or tuple(dfinal.shape) != (b, h, p, n):
        raise ValueError(f"ssd_scan_bwd kernel: prev {tuple(prev.shape)}, "
                         f"decay {tuple(decay.shape)}, dprev "
                         f"{tuple(dprev.shape)}, dfinal "
                         f"{tuple(dfinal.shape)}")
    if p * n > BWD_MAX_TILE:
        raise ValueError(f"ssd_scan_bwd kernel: a (p, n) = ({p}, {n}) tile "
                         f"is more than {BWD_MAX_TILE} elements")
    dprev, dfinal = (t if _rows_ok(t, n) else t.contiguous()
                     for t in (dprev, dfinal))
    _state_rows("prev", prev, n)
    dev = prev.device
    dstates = torch.empty((b, c, h, p, n), dtype=torch.float32, device=dev)
    ddecay = torch.empty((b, c, h), dtype=torch.float32, device=dev)
    ds0 = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if ds0.numel() == 0:
        return dstates, ddecay.zero_(), ds0
    dims = _build.int64s((b, c, h, p, n))
    strides = _build.int64s((*decay.stride(), *prev.stride()[:4],
                             *dprev.stride()[:4], *dfinal.stride()[:3],
                             *dstates.stride()[:4], *ddecay.stride(),
                             *ds0.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_fn()(decay.data_ptr(), prev.data_ptr(), dprev.data_ptr(),
                        dfinal.data_ptr(), dstates.data_ptr(),
                        ddecay.data_ptr(), ds0.data_ptr(), dims, strides,
                        stream)
    _build.check(err, "ssd_scan_bwd")
    BWD_LAUNCHES += 1
    return dstates, ddecay, ds0
