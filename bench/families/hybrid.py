"""The hybrid model (Zamba2's family): Mamba2 layers and one attention +
MLP block (the dense family's) whose weights every application shares,
applied after each group of ``attn_every`` Mamba2 layers and after the
last, shorter group.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

from bench.families import dense
from bench.harness.shapes import itemsize
from bench.harness.weights import Leaf, embedding

config = dense.config


def ssm_dims(m: Dict):
    """(d_inner, state N, heads H, head dim P) of a Mamba2 layer."""
    di = m["ssm_expand"] * m["d_model"]
    return di, m["ssm_state"], di // m["ssm_headdim"], m["ssm_headdim"]


def ssm_layer(prefix: str, m: Dict) -> List[Leaf]:
    """One Mamba2 layer's leaves: its norm and mixer."""
    d, dt = m["d_model"], m["dtype"]
    di, N, H, _ = ssm_dims(m)
    return [(f"{prefix}.norm.scale", (d,), "float32", "scale"),
            (f"{prefix}.mixer.in_proj", (d, 2 * di + 2 * N + H), dt, "dense"),
            (f"{prefix}.mixer.conv_w", (4, di + 2 * N), dt, "conv"),
            (f"{prefix}.mixer.conv_b", (di + 2 * N,), dt, "bias"),
            (f"{prefix}.mixer.A_log", (H,), "float32", "a_log"),
            (f"{prefix}.mixer.D", (H,), "float32", "scale"),
            (f"{prefix}.mixer.dt_bias", (H,), "float32", "dt_bias"),
            (f"{prefix}.mixer.gate_norm", (di,), "float32", "scale"),
            (f"{prefix}.mixer.out_proj", (di, d), dt, "dense")]


def ssm_weights(m: Dict) -> int:
    """Weights a token is multiplied by in one Mamba2 layer: ``in_proj``
    and ``out_proj``."""
    d = m["d_model"]
    di, N, H, _ = ssm_dims(m)
    return d * (2 * di + 2 * N + H) + di * d


def leaves(m: Dict) -> List[Leaf]:
    out = embedding(m)
    for i in range(m["num_layers"]):
        out += ssm_layer(f"layers.{i}", m)
    return out + dense.block("shared_attn", m)


def attention_layers(m: Dict) -> int:
    """The shared block once after each group of ``attn_every``."""
    return math.ceil(m["num_layers"] / m["attn_every"])


def matmul_weights(m: Dict) -> int:
    """The Mamba2 scan's own products are left out: ``mfu`` counts low."""
    return (m["num_layers"] * ssm_weights(m)
            + attention_layers(m) * dense.block_weights(m)
            + dense.head_weights(m))


def prefill_attention_flops(m: Dict, S: int) -> int:
    return k2_work(m, S)[0]


def decode_attention_flops(m: Dict, cur: int) -> int:
    return k1_work(m, [cur], 1)[0]


def k1_work(m: Dict, contexts: Sequence[int], slots: int):
    return dense.gqa_k1_work(dense.widths(m), itemsize(m),
                             attention_layers(m), contexts, slots)


def k2_work(m: Dict, S: int):
    return dense.gqa_k2_work(dense.widths(m), itemsize(m),
                             attention_layers(m), S)
