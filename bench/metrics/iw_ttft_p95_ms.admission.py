"""iw_ttft_p95_ms.admission: the 95th percentile, over every interactive
request due inside the window, of the time from when it was due to the
return of the step that made its first token visible (ms, host clock).
A request never served counts the whole wait until the harness stopped
waiting (60 s past the window), and is counted as failed.

A per-layer metric, not an end-to-end one: with ~190 requests due in a
window, its runs spread 8-21% between their quartiles, by when each
arrival falls against the admitting steps, so no allowed bound holds it
(PERF.md).  It moves with ``itl_p95_ms``: both are set by how long the
admitting steps take."""
from bench.harness.stats import percentile


def read(run):
    w = run.window
    ttfts = [w.ttft(tr) for tr in w.iw]
    return percentile(ttfts, 95) * 1e3 if ttfts else None
