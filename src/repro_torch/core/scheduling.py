"""Instance-level request scheduling policies (§6.5): FCFS / EDF / PF / DPA.

A policy is a pure ordering function over the waiting queue: the instance
admits requests in this order until GPU memory is exhausted (requests are
non-preemptible once batched, §2.3).  Requests expose:

  arrival        absolute arrival time (s)
  tier           "IW-F" | "IW-N" | "NIW"
  ttft_deadline  absolute TTFT deadline (s); NIW uses its batch deadline
  priority       NIW only: 1 (default) or 0 (deadline approaching, §6.2)
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Sequence

from repro_torch.api.registry import register

# NIW requests still at priority 1 always sort behind every priority-0 /
# interactive request (paper: "selected only if there are no priority-0
# requests ahead in the queue").
_NIW_TAIL = 1_000_000_000.0


def _is_bg(r) -> bool:
    return r.tier == "NIW" and getattr(r, "priority", 1) == 1


def order_fcfs(reqs: Sequence, now: float) -> List:
    return sorted(reqs, key=lambda r: (_is_bg(r), r.arrival))


def order_edf(reqs: Sequence, now: float) -> List:
    """Ascending remaining-deadline d_r; expired (d_r < 0) naturally first."""
    return sorted(reqs, key=lambda r: (_is_bg(r), r.ttft_deadline - now,
                                       r.arrival))


def order_pf(reqs: Sequence, now: float) -> List:
    """All IW-F (FCFS) strictly before IW-N; NIW-bg last."""
    rank = {"IW-F": 0, "IW-N": 1, "NIW": 2}
    return sorted(reqs, key=lambda r: (_is_bg(r), rank.get(r.tier, 2),
                                       r.arrival))


def order_dpa(reqs: Sequence, now: float, tau_n: float = 30.0,
              tau_p: float = 5.0) -> List:
    """Deadline-and-Priority-Aware (§6.5).

    Buckets: (1) severely expired (d_r < -τ_n)  — starvation guard;
    (2) urgent IW-F (0 ≤ d_r ≤ τ_p); (3) urgent IW-N; (4) non-urgent IW-F;
    (5) non-urgent IW-N; (6) recently expired (-τ_n ≤ d_r < 0).
    """
    def bucket(r):
        d = r.ttft_deadline - now
        fast = r.tier == "IW-F"
        if d < -tau_n:
            return 1
        if d < 0:
            return 6
        if d <= tau_p:
            return 2 if fast else 3
        return 4 if fast else 5

    return sorted(reqs, key=lambda r: (_is_bg(r), bucket(r), r.arrival))


POLICIES: Dict[str, Callable] = {
    "fcfs": order_fcfs,
    "edf": order_edf,
    "pf": order_pf,
    "dpa": order_dpa,
}


def get_policy(name: str, **kw) -> Callable:
    fn = POLICIES[name]
    if kw:
        return functools.partial(fn, **kw)
    return fn


def order_wsl(reqs: Sequence, now: float,
              weights: Dict[str, float] | None = None) -> List:
    """Weighted-slack-first — beyond-paper: the SLA *continuum* the paper
    names as future work ("can evolve into a continuum from fast to slow,
    high to low priority").

    Each tier (or per-request ``sla_weight``) gets a weight; requests are
    ordered by slack/weight, so a tier twice as important tolerates half
    the slack before overtaking.  With weights {IW-F:inf-ish, IW-N:1}
    this degenerates to PF; with equal weights, to EDF — FCFS/EDF/PF are
    special cases of the continuum.
    """
    w = weights or {"IW-F": 8.0, "IW-N": 2.0, "NIW": 1.0}

    def key(r):
        slack = r.ttft_deadline - now
        wt = getattr(r, "sla_weight", None) or w.get(r.tier, 1.0)  # reprolint: disable=R3 -- optional per-request extension attr; not added to the __slots__ Request (memory at 10M-request scale)
        return (_is_bg(r), slack / wt, r.arrival)

    return sorted(reqs, key=key)


POLICIES["wsl"] = order_wsl


# Every ordering function doubles as a registry-resolvable Scheduler:
# resolve("scheduler", "dpa") or resolve("scheduler",
# PolicySpec("dpa", {"tau_p": 10.0})) — extra kwargs are bound with
# functools.partial, keeping the (requests, now) call shape.
for _name in POLICIES:
    register("scheduler", _name)(
        lambda ctx, _n=_name, **kw: get_policy(_n, **kw))
