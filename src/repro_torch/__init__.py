"""PyTorch/CUDA port of the ``repro`` package.

``src/repro`` (JAX) is the frozen reference; each module here keeps its
counterpart's name and public layouts so the two can be held against
each other.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.

    Raises when CUDA is requested (explicitly or by default) and absent,
    so nothing silently carries on on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

