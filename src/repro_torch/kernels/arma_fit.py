"""Batched ARMA(p, q) CSS/Adam fit: wrapper of the CUDA kernel ``csrc/arma_fit.cu``.

Port of the JAX program ``repro.control.forecast._fit_arma_batch`` (a
vmap of ``lax.scan`` Adam steps over ``value_and_grad`` of the
``lax.scan`` CSS recursion).  One block of 256 threads fits one row with
every Adam step inside the kernel, by a blocked scan over the row's
chunks (``ref.arma_chunks``); rows never interact, so a row's parameters
are the same bits alone, in any batch and in any order.  This wrapper
only launches: it raises for tensors that are not on a CUDA device.
``ops.arma_fit`` picks between it and the plain version,
``ref.arma_fit_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0
#: largest p + q the kernel is instantiated for
MAX_ORDER = 8
#: shared memory a block may use (227 KB)
SMEM_BYTES = 232_448


def _head(p: int, q: int) -> int:
    """Floats of shared memory beside the row at order (p, q): the powers
    of M (6 of q x q), the two scans' warp totals (8 warps x (p+3) q),
    the reduction (8 warps x (p+q+2)) and the parameters, as
    ``csrc/arma_fit.cu``'s ``Layout`` places them."""
    k = p + 1 + q
    warps = ref.ARMA_THREADS // 32
    return 6 * q * q + warps * (p + 3) * q + warps * (k + 1) + k


#: longest row at every order: the row sits in shared memory beside the
#: largest of those heads
MAX_LEN = SMEM_BYTES // 4 - max(_head(p, MAX_ORDER - p)
                                for p in range(MAX_ORDER + 1))


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("arma_fit").arma_fit
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _bias(steps: int, device: torch.device):
    """Adam's bias corrections (``ref.adam_bias``) on the device."""
    return torch.from_numpy(ref.adam_bias(steps)).to(device)


def check_args(y, init, p: int, q: int, steps: int) -> None:
    """Raise unless the kernel takes these arguments (shapes and orders;
    the device is checked by ``arma_fit``)."""
    if p < 0 or q < 0 or p + q > MAX_ORDER:
        raise ValueError(f"arma_fit: order (p={p}, q={q}) needs p, q >= 0 "
                         f"and p + q <= {MAX_ORDER}")
    if steps < 1:
        raise ValueError(f"arma_fit: steps must be >= 1, got {steps}")
    if y.dim() != 2 or tuple(init.shape) != (y.shape[0], p + 1 + q):
        raise ValueError(f"arma_fit: y {tuple(y.shape)} must be (S, L) and "
                         f"init {tuple(init.shape)} (S, p+1+q)")
    if not 1 <= y.shape[1] <= MAX_LEN:
        raise ValueError(f"arma_fit: row length {y.shape[1]} must be in "
                         f"[1, {MAX_LEN}]")


def arma_fit(y, init, p: int, q: int, steps: int, lr: float):
    """y: (S, L) fp32 rows; init: (S, p+1+q) fp32 packed as (c, phi_1..p,
    theta_1..q), both on one CUDA device.  Runs ``steps`` Adam steps of
    learning rate ``lr`` on mean(e^2) per row.  Returns (params (S,
    p+1+q), loss (S,)), the loss at the last step's parameters before
    its update."""
    global LAUNCHES
    check_args(y, init, p, q, steps)
    for name, t in (("y", y), ("init", init)):
        if not t.is_cuda or t.device != y.device:
            raise ValueError(f"arma_fit kernel: {name} is on {t.device}, not "
                             f"a CUDA device (that of y)")
        if t.dtype != torch.float32:
            raise ValueError(f"arma_fit kernel: {name} has dtype {t.dtype}, "
                             f"not float32")
    n_rows, length = y.shape
    if y.stride(1) != 1:
        y = y.contiguous()
    init = init.contiguous()
    params = torch.empty_like(init)
    loss = torch.empty(n_rows, dtype=torch.float32, device=y.device)
    if n_rows == 0:
        return params, loss
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        bias = _bias(steps, y.device)
        err = _fn()(y.data_ptr(), init.data_ptr(), bias.data_ptr(),
                    params.data_ptr(), loss.data_ptr(), n_rows, length,
                    y.stride(0), p, q, steps, lr, stream)
    _build.check(err, "arma_fit")
    LAUNCHES += 1
    return params, loss
