"""The port's own spans, on the host clock that the device trace can be joined to.

A span is one interval of host time at a layer boundary of the program
(the serving engine's step, admission, each prefill, the decode and the
host's waits for the device inside them).  Spans go into one bounded,
process-wide ring, the way ``torch.profiler``'s state is process-wide,
so that whoever reads them (a benchmark, a test) needs no handle on the
engine.  Each entry is a :class:`Span`'s fields (``spans()`` names
them); the ring keeps the newest ``CAPACITY`` and counts those it
dropped.

- **Clock.**  Stamps are ``time.perf_counter_ns()``: CLOCK_MONOTONIC,
  the clock behind ``time.perf_counter``, so a stamp over 1e9 is on the
  same seconds as a caller's ``perf_counter()`` readings.
- **Link to the device trace.**  ``profiler_ns(t)`` converts a stamp to
  the timebase of ``torch.profiler``'s events (``start_ns()`` of a
  ``kineto_results`` event: Unix-epoch nanoseconds), by an offset read
  from a (``time_ns``, ``perf_counter_ns``) pair at import and again
  whenever a span finds the profiler newly switched on.
- **Profiler mirror.**  While a profiler records, each span also opens
  ``record_function(name)``, so a CPU profile shows it; otherwise no
  ``record_function`` is entered.  ``range(name)`` is that mirror alone
  (for kernels launched through ctypes): a ``record_function`` while the
  profiler records, else one shared no-op, and nothing in the ring.

Spans are for single-threaded callers (the engine's step loop): the
stack of open spans that gives each its parent is the ring's own.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Deque, List, NamedTuple

import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

#: spans the ring holds; the oldest are dropped (and counted) beyond it
CAPACITY = 65_536

_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    """One closed span: ``parent_seq`` -1 at the top, ``rid`` -1 where it
    serves no single request; ``n`` is the span's count (slots, tokens,
    queue length: each name says which)."""

    seq: int
    parent_seq: int
    name: str
    t0: int
    t1: int
    step: int
    rid: int
    n: int


def _offset_ns(tries: int = 8) -> int:
    """Profiler time minus ``perf_counter_ns`` time: a ``time_ns()`` read
    against the middle of the two ``perf_counter_ns()`` reads around it,
    from the tightest of ``tries`` such triples (a host that preempts
    the process between two reads would skew a single one)."""
    best = None
    for _ in [None] * tries:
        a = time.perf_counter_ns()
        wall = time.time_ns()  # reprolint: disable=R4 -- the profiler stamps its events in Unix time: the offset to it is the point
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class Ring:
    """The newest ``capacity`` spans, as plain tuples in :class:`Span`'s
    field order (closed in time order, so their ends never decrease),
    how many were added, and the end of the latest dropped (-1 while
    none was)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.spans: Deque[tuple] = deque(maxlen=capacity)
        self.added = 0
        self.dropped_t1 = -1
        self.next_seq = 0
        self.open: List[int] = []
        self.offset_ns = _offset_ns()
        self.profiling = False

    def add(self, entry: tuple) -> None:
        if self.added >= self.capacity:
            self.dropped_t1 = self.spans[0][4]
        self.spans.append(entry)
        self.added += 1

    @property
    def dropped(self) -> int:
        return self.added - len(self.spans)

    def dropped_since(self, t_ns: int) -> bool:
        """Whether a span that ended at or after ``t_ns`` was dropped."""
        return self.dropped_t1 >= t_ns


RING = Ring()


def profiler_ns(t: int) -> int:
    """The stamp ``t`` (``perf_counter_ns``) in the profiler's timebase."""
    return t + RING.offset_ns


def _recording() -> bool:
    """Whether the profiler records.  When it has just switched on, the
    clocks' offset is read again, after an empty ``tracing.clock`` range
    that takes the profiler's first-event set-up (0.1-0.3 ms on a CPU
    host) off the first span."""
    on = _profiler._is_profiler_enabled
    if on and not RING.profiling:
        with record_function("tracing.clock"):
            pass
        RING.offset_ns = _offset_ns()
    RING.profiling = on
    return on


class span:
    """``with span(name, step, rid, n) as s:`` records one span; the
    block may set ``s.n``.  After the block, ``s.t0``/``s.t1`` hold its
    stamps."""

    __slots__ = ("name", "step", "rid", "n", "seq", "parent", "t0", "t1",
                 "_mirror")

    def __init__(self, name: str, step: int = -1, rid: int = -1,
                 n: int = 0):
        self.name, self.step, self.rid, self.n = name, step, rid, n

    def __enter__(self) -> "span":
        ring = RING
        self.seq = ring.next_seq
        ring.next_seq += 1
        self.parent = ring.open[-1] if ring.open else -1
        ring.open.append(self.seq)
        self._mirror = record_function(self.name) if _recording() else None
        self.t0 = time.perf_counter_ns()
        if self._mirror is not None:
            self._mirror.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        ring = RING
        ring.open.pop()
        ring.add((self.seq, self.parent, self.name, self.t0, self.t1,
                  self.step, self.rid, self.n))


def mark(name: str, step: int = -1, rid: int = -1, n: int = 0) -> int:
    """Record a span of zero length now; returns its stamp."""
    ring = RING
    t = time.perf_counter_ns()
    ring.add((ring.next_seq, ring.open[-1] if ring.open else -1, name, t, t,
              step, rid, n))
    ring.next_seq += 1
    return t


def range(name: str):  # noqa: A001 - the profiler's word for it
    """A ``record_function(name)`` while the profiler records, else a
    shared no-op; adds nothing to the ring."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NOOP


def spans() -> List[Span]:
    """The ring's spans, in the order they closed."""
    return [Span._make(t) for t in RING.spans]
