"""iw_queue_wait_p50_ms: the median, over the interactive requests due
inside the window and admitted before it closed, of the time from when
each was due to the start of the step that admitted it (ms, host
clock): the wait that admission (DPA order, free slots) adds."""
from bench.harness.stats import percentile


def read(run):
    w = run.window
    waits = [tr.admit_start - tr.due for tr in w.iw
             if tr.admit_start <= w.t_end]
    return percentile(waits, 50) * 1e3 if waits else None
