"""k1_roofline: the traced steps' decode attention (K1,
``kernels/decode_attention.py`` -> ``csrc/decode_attention.cu``) against
its roofline (%): the least time the card could take for what those
calls need, over the summed device time of ``decode_split_mma`` /
``decode_split`` / ``decode_combine``.

What one decode step's K1 calls need is the model's family module's
``k1_work`` (``bench/families/<family>.py``): every slot's keys and
values at positions 0..cur with their positions, each query read and
each output written once, at the family's q/k and v head widths.
"""
from bench.harness import peaks

KERNELS = ("decode_split", "decode_combine")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(*KERNELS)
    if t <= 0:
        return None
    work = [run.family.k1_work(run.model, s.contexts, run.slots)
            for s in run.traced]
    bound = peaks.bound_s(sum(f for f, _ in work), sum(b for _, b in work))
    return 100.0 * bound / t
