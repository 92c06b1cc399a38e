"""Counts of a configuration's layers, from its ``model`` section."""
from __future__ import annotations

import math
from typing import Dict


def attention_layers(m: Dict) -> int:
    """Attention applications per token: every block of a dense model; the
    shared block once after each group of ``attn_every`` Mamba2 layers."""
    if m["family"] == "hybrid":
        return math.ceil(m["num_layers"] / m["attn_every"])
    return m["num_layers"]


def ssm_dims(m: Dict):
    """(d_inner, state N, heads H, head dim P) of a Mamba2 layer."""
    di = m["ssm_expand"] * m["d_model"]
    return di, m["ssm_state"], di // m["ssm_headdim"], m["ssm_headdim"]


def itemsize(m: Dict) -> int:
    """Bytes of one element in the model's dtype."""
    return {"bfloat16": 2, "float16": 2, "float32": 4}[m["dtype"]]


def padded_vocab(m: Dict) -> int:
    k = m["vocab_pad_multiple"]
    return (m["vocab_size"] + k - 1) // k * k
