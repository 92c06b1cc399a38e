"""itl_p95_ms: the 95th percentile of every gap between consecutive
visible tokens of every request, over the window (ms, host clock).
Two tokens made visible by one step (an admitted request's prefill token
and its first decode token) have a gap of 0."""
from bench.harness.stats import percentile


def read(run):
    gaps = run.window.gaps()
    return percentile(gaps, 95) * 1e3 if gaps else None
