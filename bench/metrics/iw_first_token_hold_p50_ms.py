"""iw_first_token_hold_p50_ms: the median, over the interactive requests
due inside the window and admitted before it closed, of the time from
the end of each one's ``serve.first_token`` (its first token on the
host) to the end of its ``serve.step``, when the engine returns it (ms,
host clock, ``repro_torch.tracing``): the later prefills of the step and
the decode of every slot, which a ready first token waits out."""
from bench.harness import spans
from bench.harness.stats import percentile


def read(run):
    sp = spans.of(run.window)
    if sp is None:
        return None
    first = sp.by_rid("serve.first_token")
    steps = {s.step: s for s in sp.named("serve.step")}
    holds = [steps[first[pre.rid].step].t1 - first[pre.rid].t1
             for _, pre in spans.iw_admitted(run, sp)
             if pre.rid in first and first[pre.rid].step in steps]
    return percentile(holds, 50) / 1e6 if holds else None
