"""NIW Queue Manager (§6.2).

NIW requests are parked here by the global router and drip-fed to
(model, region) endpoints when those endpoints signal spare capacity:
util < ``one_thresh`` releases one request per live instance,
util < ``two_thresh`` two per instance.  Requests older than
``promote_age`` — or whose 24 h deadline is within ``deadline_slack`` —
are promoted to priority 0 (treated on par with IW, §6.2) and force-
released.

Queues are FIFO per model; since NIW deadlines are arrival + constant,
age/deadline promotion only ever applies to queue heads, keeping every
operation O(released), not O(queue) — this matters at 10M-request scale.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.api.registry import register

Key = Tuple[str, str]  # (model, region)


class QueueManager:
    def __init__(self, one_thresh: float = 0.6, two_thresh: float = 0.5,
                 promote_age: float = 10 * 3600.0,
                 deadline_slack: float = 2 * 3600.0):
        self.one_thresh = one_thresh
        self.two_thresh = two_thresh
        self.promote_age = promote_age
        self.deadline_slack = deadline_slack
        self.queues: Dict[str, Deque] = collections.defaultdict(
            collections.deque)   # per model (region chosen at release)
        self._tokens: Dict[str, float] = collections.defaultdict(float)
        self.enqueued = 0
        self.released = 0

    # ---------------------------------------------------------------- intake
    def submit(self, request) -> None:
        request.priority = getattr(request, "priority", 1)
        self.queues[request.model].append(request)
        self._tokens[request.model] += (request.prompt_tokens
                                        + request.output_tokens)
        self.enqueued += 1

    def depth(self, model: Optional[str] = None) -> int:
        # read-only probe: .get, never indexing — indexing a defaultdict
        # inserts an empty deque per unknown key, growing state with
        # every speculative query
        if model is not None:
            q = self.queues.get(model)
            return len(q) if q is not None else 0
        return sum(len(q) for q in self.queues.values())

    def backlog_tokens(self, model: str) -> float:
        return self._tokens.get(model, 0.0)

    # --------------------------------------------------------------- signals
    def on_capacity_signal(self, model: str, region: str, util: float,
                           now: float, live_instances: int = 1) -> List:
        """Endpoint (model, region) reports spare capacity.

        Releases 1 (util < one_thresh) or 2 (util < two_thresh) requests
        per live instance — FIFO, so the oldest (closest to promotion)
        leave first.  A signal from an endpoint with no live instances
        (fully draining, undeployed, or dead) releases nothing: a
        request stamped onto a dead (model, region) would never be
        served.
        """
        if live_instances < 1:
            return []
        per_inst = 2 if util < self.two_thresh else (
            1 if util < self.one_thresh else 0)
        n = per_inst * live_instances
        if n <= 0 or model not in self.queues:
            return []
        q = self.queues[model]
        out = []
        while q and len(out) < n:
            r = q.popleft()
            self._tokens[model] -= r.prompt_tokens + r.output_tokens
            if (now - r.arrival >= self.promote_age
                    or r.deadline - now <= self.deadline_slack):
                r.priority = 0
            r.region = region
            out.append(r)
        self.released += len(out)
        return out

    def force_release_expiring(self, now: float) -> List:
        """Deadline guard: heads whose deadline can no longer wait are
        promoted to priority 0 and released regardless of signals."""
        out = []
        for model, q in self.queues.items():
            while q and (q[0].deadline - now <= self.deadline_slack
                         or now - q[0].arrival >= self.promote_age):
                r = q.popleft()
                self._tokens[model] -= r.prompt_tokens + r.output_tokens
                r.priority = 0
                out.append(r)
        self.released += len(out)
        return out


@register("queue", "niw")
def _make_queue_manager(ctx, **kwargs) -> QueueManager:
    return QueueManager(**kwargs)
