"""prefill_ms_per_ktok.engine: the engine's ``serve.prefill`` spans of
the window summed, over the prompt tokens they admitted, per 1,000 (ms,
host clock, ``repro_torch.tracing``): each B=1 prefill, its first
token's wait for the card and its slot write.  ``prefill_ms_per_ktok``
is its outside twin, what admitting steps took beyond a decode step."""
from bench.harness import spans


def read(run):
    sp = spans.of(run.window)
    pre = sp.named("serve.prefill") if sp else []
    tokens = sum(s.n for s in pre)
    if not tokens:
        return None
    return sum(s.t1 - s.t0 for s in pre) / 1e6 / (tokens / 1e3)
