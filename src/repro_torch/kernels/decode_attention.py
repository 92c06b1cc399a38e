"""Flash-decode attention: wrapper of the CUDA kernel ``csrc/decode_attention.cu``.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_decode_kernel``).  The kernel takes the reference's public layout,
q (B,H,hd), k/v (B,Hkv,T,hd), k_pos (B,T), cur_pos (B,), through
strides, so the model hands it a transposed view of its (B,W,Hkv,hd)
cache without a copy; any T works.  It splits the cache axis across
blocks and merges their partial results (bf16: the last block of each
kv head and sequence, counted on a ticket; fp32: a second pass); this
wrapper chooses the number of blocks (:func:`split_plan`) and allocates
the partial results and the tickets.  It only launches: it raises for
tensors that are not on a CUDA device.
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

HEAD_DIMS = (16, 32, 64, 96, 112, 128, 160, 256)
_PAIRS = tuple((d, d) for d in HEAD_DIMS)  # V at q/k's head dim
MAX_GROUP = 16     # GMAX in the source: query heads per kv head
TILE = 64          # chunks (fp32 kernel) are multiples of this
MAX_CHUNK = 1984   # so a bf16 piece, rounded to 16 slots, fits PIECE_MAX = 2048
RESIDENT = 2       # bf16 blocks an SM holds at hd <= 128 (shared memory)
MIN_BLOCK_BYTES = 256 << 10  # K/V bytes of a full cache a block streams at least


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        _build.INT64_PTR, _build.INT64_PTR, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS = {}
#: ticket buffers that a larger one replaced, never freed: a CUDA graph
#: captured over one reads it at its address for the graph's life
_RETIRED = []


def _tickets(dev, stream: int, n: int) -> torch.Tensor:
    """n zeroed int32 counters for the bf16 kernel's merge, one buffer
    per (device, stream); the kernel leaves them at zero."""
    buf = _TICKETS.get((dev, stream))
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _TICKETS[(dev, stream)] = buf
    return buf


def split_plan(B: int, Hkv: int, T: int, hd: int, itemsize: int,
               num_sms: int):
    """(nsplit, chunk): how many blocks share one (kv head, sequence).

    The bf16 kernel cuts the sequence's kept slot range into nsplit
    equal pieces (the kept range is known only on the card); the fp32
    kernel cuts the cache axis into nsplit chunks of ``chunk`` slots.
    A bf16 block pays a fixed cost of a few microseconds (the scan of the
    positions, the query fragments, the first loads, the merge) before
    and after it streams, so the plan makes one wave: about
    ``RESIDENT`` blocks per SM in all, none streaming less than
    ``MIN_BLOCK_BYTES`` of a full cache, none more than ``MAX_CHUNK``
    slots (on an H100, fewer and longer pieces ran faster than more and
    shorter ones at both served decode shapes).  chunk is a multiple of
    ``TILE`` and the nsplit chunks cover T.
    """
    def cdiv(x, y):
        return -(-x // y)

    row = 2 * hd * itemsize                    # K and V bytes per slot
    want = cdiv(RESIDENT * num_sms, max(1, B * Hkv))
    cap = max(1, T * row // MIN_BLOCK_BYTES)
    nsplit = max(min(want, cap), cdiv(T, MAX_CHUNK))
    chunk = cdiv(cdiv(T, nsplit), TILE) * TILE
    return cdiv(T, chunk), chunk


def decode_attention(q, k, v, k_pos, cur_pos, *, scale: float,
                     window: int = 0):
    """q: (B,H,hd); k/v: (B,Hkv,T,hd); k_pos: (B,T); cur_pos: (B,).

    Returns (B,H,hd) in ``q.dtype``.
    """
    global LAUNCHES
    _build.check_qkv("decode_attention", _PAIRS, dict(q=q, k=k), dict(v=v))
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
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    nsplit, chunk = split_plan(B, Hkv, T, hd, q.element_size(),
                               _num_sms(index))
    # one scratch buffer for the chunks' partial (m, l, acc); none when
    # a bf16 cache axis is not split (the kernel writes the output itself)
    rows = B * Hkv * nsplit * g if nsplit > 1 or q.dtype != torch.bfloat16 \
        else 0
    part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=dev)
    m_part, l_part, acc_part = (part[:rows], part[rows:2 * rows],
                                part[2 * rows:])
    dims = _build.int64s((B, H, Hkv, T, hd, nsplit, chunk))
    strides = _build.int64s((*q.stride()[:2], *k.stride()[:3],
                             *v.stride()[:3], *out.stride()[:2],
                             *k_pos.stride(), *cur_pos.stride()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _tickets(index, stream, B * Hkv)
        err = _fn()(_build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), k_pos.data_ptr(), cur_pos.data_ptr(),
                    out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                    acc_part.data_ptr(), tickets.data_ptr(), dims, strides,
                    float(scale), int(window), stream)
    _build.check(err, "decode_attention_fwd")
    LAUNCHES += 1
    return out
