"""Sizes of a configuration that hold for every family, from its
``model`` section (a family's own are in ``bench/families/<family>.py``)."""
from __future__ import annotations

from typing import Dict


def itemsize(m: Dict) -> int:
    """Bytes of one element in the model's dtype."""
    return {"bfloat16": 2, "float16": 2, "float32": 4}[m["dtype"]]


def padded_vocab(m: Dict) -> int:
    k = m["vocab_pad_multiple"]
    return (m["vocab_size"] + k - 1) // k * k
