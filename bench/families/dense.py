"""The dense decoder (StarCoder2's family): pre-norm attention + MLP
blocks, grouped-query attention with q/k and v at ``head_dim``.

The attention work below is written for any widths (:func:`gqa_k1_work`,
:func:`gqa_k2_work`), so that a family whose q/k and v heads differ can
give its own.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from bench.harness.shapes import itemsize, padded_vocab
from bench.harness.weights import Leaf, embedding, norm

Widths = Tuple[int, int, int, int]   # heads, KV heads, q/k width, v width


def config(m: Dict):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**m)


def block(prefix: str, m: Dict) -> List[Leaf]:
    """One attention + MLP block's leaves."""
    d, H, Hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    ln, dt = m["norm"] == "layernorm", m["dtype"]
    out = norm(f"{prefix}.norm1", d, ln)
    out += [(f"{prefix}.attn.wq", (d, H * hd), dt, "dense"),
            (f"{prefix}.attn.wk", (d, Hkv * hd), dt, "dense"),
            (f"{prefix}.attn.wv", (d, Hkv * hd), dt, "dense"),
            (f"{prefix}.attn.wo", (H * hd, d), dt, "dense")]
    if m["use_qkv_bias"]:
        out += [(f"{prefix}.attn.bq", (H * hd,), dt, "bias"),
                (f"{prefix}.attn.bk", (Hkv * hd,), dt, "bias"),
                (f"{prefix}.attn.bv", (Hkv * hd,), dt, "bias")]
    out += norm(f"{prefix}.norm2", d, ln)
    f = m["d_ff"]
    out += [(f"{prefix}.mlp.wi", (d, f), dt, "dense"),
            (f"{prefix}.mlp.wo", (f, d), dt, "dense")]
    if m["act"] in ("silu", "geglu"):
        out.append((f"{prefix}.mlp.wg", (d, f), dt, "dense"))
    return out


def leaves(m: Dict) -> List[Leaf]:
    out = embedding(m)
    for i in range(m["num_layers"]):
        out += block(f"dense_layers.{i}", m)
    return out


def attention_layers(m: Dict) -> int:
    return m["num_layers"]


def widths(m: Dict) -> Widths:
    hd = m["head_dim"]
    return m["num_heads"], m["num_kv_heads"], hd, hd


def block_weights(m: Dict) -> int:
    """Weights a token is multiplied by in one block: the q/k/v/o
    projections and the MLP."""
    d, H, Hkv, hd, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                        m["head_dim"], m["d_ff"])
    attn = 2 * d * H * hd + 2 * d * Hkv * hd
    mlp = (3 if m["act"] in ("silu", "geglu") else 2) * d * f
    return attn + mlp


def head_weights(m: Dict) -> int:
    """The output head's (the embedding is a gather)."""
    return m["d_model"] * padded_vocab(m)


def matmul_weights(m: Dict) -> int:
    return m["num_layers"] * block_weights(m) + head_weights(m)


def prefill_attention_flops(m: Dict, S: int) -> int:
    return k2_work(m, S)[0]


def decode_attention_flops(m: Dict, cur: int) -> int:
    return k1_work(m, [cur], 1)[0]


def k1_work(m: Dict, contexts: Sequence[int], slots: int):
    return gqa_k1_work(widths(m), itemsize(m), attention_layers(m),
                       contexts, slots)


def k2_work(m: Dict, S: int):
    return gqa_k2_work(widths(m), itemsize(m), attention_layers(m), S)


def gqa_k1_work(w: Widths, isz: int, n: int, contexts: Sequence[int],
                slots: int):
    """(flops, bytes) of one decode step of K1 over ``slots`` slots, the
    active ones at positions ``contexts``, in ``n`` attention
    applications: every slot's keys and values at positions 0..cur with
    their int32 positions (an idle slot decodes at position 0: one key),
    each query read and each output written once with the slot's
    position; 2 H (dqk + dv) FLOPs a kept key (scores and values)."""
    H, Hkv, dqk, dv = w
    keys = sum(c + 1 for c in contexts) + (slots - len(contexts))
    nbytes = keys * (Hkv * (dqk + dv) * isz + 4) \
        + slots * (H * (dqk + dv) * isz + 4)
    flops = keys * 2 * H * (dqk + dv)
    return n * flops, n * nbytes


def gqa_k2_work(w: Widths, isz: int, n: int, S: int):
    """(flops, bytes) of K2 over one causal prompt of ``S`` tokens, in
    ``n`` attention applications: H (dqk + dv) S (S + 1) FLOPs (each query
    against the keys up to it, scores and values); q, k, v read and the
    output written once, with the query and key positions (int32)."""
    H, Hkv, dqk, dv = w
    flops = H * (dqk + dv) * S * (S + 1)
    nbytes = (H + Hkv) * (dqk + dv) * S * isz + 2 * S * 4
    return n * flops, n * nbytes
