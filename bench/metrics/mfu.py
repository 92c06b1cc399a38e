"""mfu: the model FLOPs of the window's steps over the window's wall time
at the card's bf16 peak (%), host clock: no profiler runs in the window.

Model FLOPs: 2 x the weights each token is multiplied by x the tokens
(every prompt token of each admitted prefill, the head included, and
one token for each active slot's decode; idle slots count nothing),
plus the attention of each causal prefill and each decode, all as the
model's family module counts them (``bench/families/<family>.py``:
``matmul_weights``, ``prefill_attention_flops``,
``decode_attention_flops``).  The Mamba2 scan's own products are left
out, so for a hybrid model this counts low.
"""
from bench.harness import peaks


def step_flops(family, m, prompts, contexts):
    """Model FLOPs of one step that admitted ``prompts`` and decoded at
    positions ``contexts``."""
    w = family.matmul_weights(m)
    flops = sum(2 * w * S + family.prefill_attention_flops(m, S)
                for S in prompts)
    flops += sum(2 * w + family.decode_attention_flops(m, c)
                 for c in contexts)
    return flops


def read(run):
    w = run.window
    if not w.steps or w.t_end <= w.t0:
        return None
    flops = sum(step_flops(run.family, run.model, s.prompts, s.contexts)
                for s in w.steps)
    return 100.0 * flops / ((w.t_end - w.t0) * peaks.BF16_FLOPS)
