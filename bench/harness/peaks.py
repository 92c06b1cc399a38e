"""Published peaks of the card the benchmark reads shares against.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bf16, 3.35 TB/s of HBM bandwidth.  A
card set below 700 W runs slower under load; the run prints the card's
power limit beside every share.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
