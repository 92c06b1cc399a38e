"""k1_roofline: the traced steps' decode attention (K1,
``kernels/decode_attention.py`` -> ``csrc/decode_attention.cu``) against
its roofline (%): the least time the card could take for what those
calls need, over the summed device time of ``decode_split_mma`` /
``decode_split`` / ``decode_combine``.

What one decode step's K1 calls need, per attention application: every
slot's keys and values at positions 0..cur, with their int32 positions
(an idle slot decodes at position 0: one), each query read and each
output written once, and the slots' current positions; 4 H hd FLOPs per
kept key (scores and values).
"""
from bench.harness import peaks, shapes

KERNELS = ("decode_split", "decode_combine")


def k1_work(m, contexts, slots):
    """(flops, bytes) of one decode step over ``slots`` slots, of which
    the active ones decode at positions ``contexts``."""
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    isz = shapes.itemsize(m)
    keys = sum(c + 1 for c in contexts) + (slots - len(contexts))
    nbytes = keys * (2 * Hkv * hd * isz + 4) + slots * (2 * H * hd * isz + 4)
    flops = keys * 4 * H * hd
    n = shapes.attention_layers(m)
    return n * flops, n * nbytes


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(*KERNELS)
    if t <= 0:
        return None
    work = [k1_work(run.model, s.contexts, run.slots) for s in run.traced]
    bound = peaks.bound_s(sum(f for f, _ in work), sum(b for _, b in work))
    return 100.0 * bound / t
