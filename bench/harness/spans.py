"""The program's own spans (``repro_torch.tracing``) inside a run's window.

The serving engine records a span for each step (``serve.step``), its
admission, each prefill with its first token and slot write, and its
decode with the sampling, on ``time.perf_counter_ns()``: the clock of
the harness's ``time.perf_counter`` in nanoseconds.  ``of(window)``
keeps the spans that lie inside ``[window.t0, window.t_end]``: the
window's steps with everything inside them, and the ``serve.submit``
marks between them (the traced stretch comes after).  It returns
None where there is nothing to read: a program that keeps no spans, a
window on another clock (no step inside it), or a ring that dropped
spans from inside the window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class Spans:
    inner: List            # every span inside the window, its steps too

    def named(self, name: str) -> List:
        return [s for s in self.inner if s.name == name]

    def by_rid(self, name: str) -> Dict[int, object]:
        return {s.rid: s for s in self.named(name)}


def of(window) -> Optional[Spans]:
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t0, t1 = round(window.t0 * 1e9), round(window.t_end * 1e9)
    if tracing.RING.dropped_since(t0):
        return None
    inner = [s for s in tracing.spans() if t0 <= s.t0 and s.t1 <= t1]
    if not any(s.name == "serve.step" for s in inner):
        return None
    return Spans(inner)


def iw_admitted(run, sp: Spans) -> List:
    """The interactive requests due inside the window and admitted
    before it closed: (submit mark, prefill span) of each."""
    submits, prefills = sp.by_rid("serve.submit"), sp.by_rid("serve.prefill")
    out = []
    for tr in run.window.iw:
        rid = tr.req.rid
        if rid in submits and rid in prefills:
            out.append((submits[rid], prefills[rid]))
    return out
