"""The products the references run: exact float32, or the control's fp8.

``exact`` is a float32 product with TF32 off (:func:`no_tf32`).  ``fp8``
is the control of the check: the nearest precision below the served
bfloat16, each operand rounded to float8 e4m3 (the activations per row,
the weights per output column, each scaled so that its largest value is
e4m3's largest, 448) and the product then taken in float32.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def round_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return round_e4m3(x, -1) @ round_e4m3(w, 0)
