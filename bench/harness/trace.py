"""Read a stretch of engine steps from ``torch.profiler``'s device trace.

The traced stretch is a few steps run under the profiler, each inside a
``bench.step`` range, with the engine's prefill and decode calls inside
``engine.prefill`` / ``engine.decode`` ranges that the benchmark wraps
around them.  On the card the profiler records the device's activity
alone (kernels, copies, and the runtime calls on the host that launch
them), so those ranges are not in the trace and the stretch is the span
of its events.  From it come every device operation's name and time, the
device's busy time (the union of its operations' intervals) within the
stretch, and its idle time, each idle stretch named by what the host was
doing at its middle: the runtime call or range in flight, or none.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

STEP = "bench.step"
#: the ranges the benchmark opens; the profiler shows them on the device
#: timeline too, where they are no device work
RANGES = (STEP, "engine.prefill", "engine.decode")
#: idle stretches named by the host op at their middle, longest first
NAMED_GAPS = 500


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, float]]          # (name, seconds), each device op
    busy_s: float
    window_s: float
    idle_by_host: Dict[str, float]

    def seconds(self, *names: str, but: Tuple[str, ...] = ()) -> float:
        """Device seconds of the ops whose name holds one of ``names`` and
        none of ``but``."""
        return sum(s for n, s in self.ops
                   if any(k in n for k in names)
                   and not any(k in n for k in but))

    def breakdown(self) -> Dict:
        by_op = defaultdict(float)
        for name, s in self.ops:
            by_op[name] += s
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list (the first parenthesis outside template brackets)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def _ranged(label: str, fn):
    from torch.autograd.profiler import record_function

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def ranges(engine):
    """Wrap the engine's prefill and decode calls in named ranges while
    the block runs (only the traced stretch pays for them)."""
    saved = {}
    for attr, label in (("_prefill", "engine.prefill"),
                        ("_decode", "engine.decode")):
        if hasattr(engine, attr):
            saved[attr] = getattr(engine, attr)
            setattr(engine, attr, _ranged(label, saved[attr]))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(engine, attr, fn)


def _span(e) -> Tuple[float, float]:
    """A profiler event's (start, end) in microseconds."""
    start = e.start_ns() / 1e3
    return start, start + e.duration_ns() / 1e3


def read(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``, from its
    raw events (``kineto_results``: the profiler's own event tree takes
    about 80 us an event to build, these under 1 us)."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    steps = [_span(e) for e in events if e.name() == STEP
             and e.device_type() == DeviceType.CPU]
    # where the profiler records the device alone, the steps' ranges are
    # not in the trace: the stretch runs from its first event to its last
    bounds = steps or [_span(e) for e in events]
    if not bounds:
        return Trace([], 0.0, 0.0, {})
    lo = min(a for a, _ in bounds)
    hi = max(b for _, b in bounds)
    dev, host = [], []
    for e in events:
        a, b = _span(e)
        if e.device_type() == DeviceType.CPU:
            if e.name() != STEP:
                host.append((a, b, e.name()))
        elif not e.is_user_annotation() and e.name() not in RANGES \
                and b > lo and a < hi:
            dev.append((a, b, e.name()))
    ops = [(short(n) or "(unnamed)", (b - a) / 1e6) for a, b, n in dev]
    merged: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b, _ in dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    # name the longest idle stretches one by one, the many short ones
    # between launches together
    idle.sort(key=lambda ab: ab[0] - ab[1])
    named, rest = idle[:NAMED_GAPS], idle[NAMED_GAPS:]
    by_host: Dict[str, float] = defaultdict(float)
    if rest:
        label = f"gaps under {named[-1][1] - named[-1][0]:.0f} us"
        by_host[label] = sum(b - a for a, b in rest) / 1e6
    starts = np.array([a for a, _, _ in host], dtype=np.float64)
    ends = np.array([b for _, b, _ in host], dtype=np.float64)
    for a, b in named:
        mid = (a + b) / 2
        if steps and not any(s <= mid <= e for s, e in steps):
            by_host["harness, between steps"] += (b - a) / 1e6
            continue
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        names = [host[i][2] for i in inside[np.argsort(starts[inside])]]
        outer = [n for n in names if n.startswith("engine.")]
        inner = [n for n in names if not n.startswith("engine.")]
        label = " > ".join(outer[:1] + inner[-1:]) or "python (no op)"
        by_host[label] += (b - a) / 1e6
    return Trace(ops, busy / 1e6, (hi - lo) / 1e6, dict(by_host))
