"""k2_roofline: the traced steps' prefill attention (K2,
``kernels/flash_attention.py`` -> ``csrc/flash_attention.cu``) against its
roofline (%): the least time the card could take for the causal
attention of every prompt those steps admitted, over the summed device
time of ``flash_fwd_*``.

What one causal prefill needs is the model's family module's ``k2_work``
(``bench/families/<family>.py``): each query against the keys up to it,
scores and values; q, k, v read and the output written once, with the
positions, at the family's q/k and v head widths.
"""
from bench.harness import peaks

KERNELS = ("flash_fwd",)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(*KERNELS)
    if t <= 0:
        return None
    work = [run.family.k2_work(run.model, S)
            for s in run.traced for S in s.prompts]
    if not work:
        return None
    bound = peaks.bound_s(sum(f for f, _ in work), sum(b for _, b in work))
    return 100.0 * bound / t
