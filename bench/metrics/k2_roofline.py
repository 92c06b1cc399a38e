"""k2_roofline: the traced steps' prefill attention (K2,
``kernels/flash_attention.py`` -> ``csrc/flash_attention.cu``) against its
roofline (%): the least time the card could take for the causal
attention of every prompt those steps admitted, over the summed device
time of ``flash_fwd_*``.

One causal prefill of S tokens, per attention application: 2 H hd
S (S + 1) FLOPs (each query against the keys up to it, scores and
values); q, k, v read and the output written once, with the query and
key positions (int32).
"""
from bench.harness import peaks, shapes

KERNELS = ("flash_fwd",)


def k2_work(m, S):
    """(flops, bytes) of one prompt of ``S`` tokens."""
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    isz = shapes.itemsize(m)
    flops = 2 * H * hd * S * (S + 1)
    nbytes = (2 * H + 2 * Hkv) * S * hd * isz + 2 * S * 4
    n = shapes.attention_layers(m)
    return n * flops, n * nbytes


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(*KERNELS)
    if t <= 0:
        return None
    work = [k2_work(run.model, S) for s in run.traced for S in s.prompts]
    if not work:
        return None
    bound = peaks.bound_s(sum(f for f, _ in work), sum(b for _, b in work))
    return 100.0 * bound / t
