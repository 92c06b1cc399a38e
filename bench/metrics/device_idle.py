"""device_idle: the share of the traced stretch in which no operation
ran on the card (%), from the profiler's device trace, with the host time
that the profiler itself added taken out.

The profiler slows the host at every launch it records, and where a step
is paced by the host each added microsecond is one the card waits.  The
time added is what the traced steps took beyond what the window's own,
unprofiled steps predict for them (``Window.predict_s``); it leaves the
stretch's idle time and its length.  The raw idle share, from
``device.busy_s`` and ``device.window_s``, keeps it."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    want = run.window.predict_s(run.traced)
    took = sum(s.end - s.start for s in run.traced)
    added = max(0.0, took - want) if want is not None else 0.0
    span = max(t.window_s - added, t.busy_s)
    return 100.0 * (1.0 - t.busy_s / span)
