"""ssd_scan_ms_per_ktok: the SSD scan kernel's device time (K3,
``kernels/ssd_scan.py`` -> ``csrc/ssd_scan.cu``, ``ssd_scan``) in the
traced steps, per 1,000 prompt tokens those steps admitted (ms, device
trace).  K3 runs once a Mamba2 layer in each prefill, over the prompt's
chunks, and not in decode.

No roofline: K3's inputs, the chunk states, come from the product that
wrote them just before and sit in the card's L2, so a share of the HBM
byte bound could pass 100% with the bytes counted right.
"""
KERNELS = ("ssd_scan",)
NOT = ("ssd_scan_rev",)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(*KERNELS, but=NOT)
    tokens = sum(sum(s.prompts) for s in run.traced)
    if t <= 0 or not tokens:
        return None
    return t * 1e3 / (tokens / 1e3)
