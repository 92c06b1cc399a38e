"""iw_queue_wait_p50_ms.engine: the median, over the interactive
requests due inside the window and admitted before it closed, of the
time from the engine's ``serve.submit`` of each to the start of its
``serve.prefill`` (ms, host clock, ``repro_torch.tracing``): the wait
for a step boundary, the policy's order and the prefills ahead of it.
``iw_queue_wait_p50_ms`` is its outside twin, from due to the start of
the admitting step."""
from bench.harness import spans
from bench.harness.stats import percentile


def read(run):
    sp = spans.of(run.window)
    if sp is None:
        return None
    waits = [pre.t0 - sub.t0 for sub, pre in spans.iw_admitted(run, sp)]
    return percentile(waits, 50) / 1e6 if waits else None
