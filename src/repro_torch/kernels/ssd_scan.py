"""SSD cross-chunk state scan: wrapper of the CUDA kernel ``csrc/ssd_scan.cu``.

Port of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_scan_kernel``).  The kernel takes the reference's public layout,
states (b,c,h,p,n), decay (b,c,h), s0 (b,h,p,n), all fp32, through
strides, so the model hands it its einsum output and a strided view of
the chunk decays without the Pallas wrapper's transposes.  Each (p, n)
row must be unit-stride along n, with n a multiple of 4 and rows on
16-byte boundaries.  This wrapper only launches: it raises for tensors
that are not on a CUDA device.  ``ops.ssd_state_scan`` picks between it
and the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [_build.INT64_PTR,
                                           _build.INT64_PTR, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
        if n % 4 or t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st % 4 for size, st in zip(t.shape[:-1], t.stride())
                if size > 1):
            raise ValueError(f"ssd_scan kernel: {name} must have a "
                             f"unit-stride state axis n (a multiple of 4) "
                             f"and 16-byte aligned rows (shape "
                             f"{tuple(t.shape)}, strides {t.stride()})")


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
