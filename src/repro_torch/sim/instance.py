"""Model-instance simulation: waiting queue, serial prefill, batched decode,
effective-memory accounting.

Matches the paper's instance model (§2.3): the scheduler orders the
waiting queue (FCFS/EDF/PF/DPA), admits requests while KV memory lasts,
requests are non-preemptible once batched.  Prefill is serial at
``prompt_tps`` (compute-bound); admitted requests then decode
concurrently, each with TBT degraded by instance occupancy
(memory-bound).  "Effective memory utilization" = reserved KV tokens /
capacity — the paper's load proxy that drives routing, scaling and the
NIW queue manager.  Capacities are calibrated so a fully-batched
instance sits at ~85 % effective utilization (above the 70 % scale-out
threshold), as in the production system.

All load accounting is incremental (O(1) per event) so JSQ routing stays
cheap at millions of requests; queue re-ordering falls back to FIFO past
``SORT_LIMIT`` waiting requests (deep-overload guard).

Every mutation of the load counters fires the instance's ``listener``
hook (set by the owning ``Endpoint``) with the reserved-token and
remaining-token deltas, so endpoint-level aggregates (mean utilization,
the JSQ heap) are maintained in O(1) instead of re-scanned per arrival —
see ``repro_torch.sim.cluster.Endpoint``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.sim.perfmodel import PerfProfile
from repro_torch.sim.types import Request

SORT_LIMIT = 2048
SCAN_LIMIT = 32


class Instance:
    def __init__(self, iid: str, model: str, region: str,
                 profile: PerfProfile, order_fn: Callable):
        self.iid = iid
        self.model = model
        self.region = region
        self.profile = profile
        self.order_fn = order_fn

        self.waiting: List[Request] = []
        self.prefilling: Optional[Request] = None
        self.decoding: Dict[int, Request] = {}
        self.reserved_tokens: int = 0
        self._waiting_tokens: int = 0
        self._decode_out_tokens: int = 0
        self.rem: int = 0             # cached remaining_tokens() value
        self._cap: int = profile.kv_capacity_tokens
        self._max_batch: int = profile.max_batch
        self.draining = False         # no new admissions (scale-in)
        self.acquired_at: float = 0.0
        # O(1)-aggregate hook: called as listener(self, d_reserved,
        # d_remaining) after any load-counter change (Endpoint sets it)
        self.listener: Optional[Callable] = None
        self.pf_event = None  # simulator's cached PrefillDone for this inst

    # ------------------------------------------------------------- metrics
    @property
    def util(self) -> float:
        return min(self.reserved_tokens / self.profile.kv_capacity_tokens,
                   1.0)

    @property
    def occupancy(self) -> float:
        return len(self.decoding) / max(self.profile.max_batch, 1)

    def remaining_tokens(self) -> int:
        return self.rem

    def _remaining_scan(self) -> int:
        """Reference recomputation of ``rem`` (tests/debug only)."""
        rem = self._waiting_tokens + self._decode_out_tokens
        p = self.prefilling
        if p is not None:
            rem += p.prompt_tokens + p.output_tokens
        return rem

    @property
    def idle(self) -> bool:
        return (not self.waiting and self.prefilling is None
                and not self.decoding)

    # --------------------------------------------------------------- intake
    def enqueue(self, req: Request, now: float) -> Optional[Tuple[str, float]]:
        self.waiting.append(req)
        t = req.prompt_tokens + req.output_tokens
        self._waiting_tokens += t
        self.rem += t
        lis = self.listener
        if lis is not None:
            lis(self, 0, t)
        return self.maybe_start_prefill(now)

    def maybe_start_prefill(self, now: float) -> Optional[Tuple[str, float]]:
        """Admit the next schedulable request if the prefill unit is free.

        Walks the policy-ordered queue and admits the first request that
        fits (the paper's scheduler "adds as many as possible based on
        available GPU memory" — non-fitting requests are skipped, not
        head-of-line blocking).  Requests that can never fit
        (total_tokens > capacity) are rejected outright.
        Returns ("prefill_done", t) to schedule, or None."""
        if self.prefilling is not None or not self.waiting:
            return None
        if len(self.decoding) >= self._max_batch:
            return None
        waiting = self.waiting
        if 1 < len(waiting) <= SORT_LIMIT:
            waiting = self.waiting = self.order_fn(waiting, now)
        cap = self._cap
        reserved = self.reserved_tokens
        pick = None
        idx = 0
        scanned = 0
        while idx < len(waiting) and scanned < SCAN_LIMIT:
            r = waiting[idx]
            t = r.prompt_tokens + r.output_tokens
            if t > cap:
                # can never fit on this instance type: reject outright
                waiting.pop(idx)
                self._waiting_tokens -= t
                self.rem -= t
                r.instance = "REJECTED"
                lis = self.listener
                if lis is not None:
                    lis(self, 0, -t)
                continue
            if reserved + t <= cap:
                pick = idx
                break
            idx += 1
            scanned += 1
        if pick is None:
            return None
        req = waiting.pop(pick)
        need = req.prompt_tokens + req.output_tokens
        self._waiting_tokens -= need
        self.reserved_tokens = reserved + need
        self.prefilling = req
        lis = self.listener
        if lis is not None:
            lis(self, need, 0)  # remaining unchanged: waiting → prefilling
        req.admitted = now
        req.instance = self.iid
        req.served_region = self.region
        dt = req.prompt_tokens / self.profile.prompt_tps
        return ("prefill_done", now + dt)

    # ---------------------------------------------------------------- events
    def on_prefill_done(self, now: float) -> Tuple[Request, float,
                                                   Optional[Tuple[str, float]]]:
        """Returns (request, decode_finish_time, next_prefill_event)."""
        req = self.prefilling
        assert req is not None
        self.prefilling = None
        req.ttft = now - req.arrival
        tbt = self.profile.decode_tbt(self.occupancy)
        finish = now + req.output_tokens * tbt
        self.decoding[req.rid] = req
        self._decode_out_tokens += req.output_tokens
        self.rem -= req.prompt_tokens
        lis = self.listener
        if lis is not None:
            lis(self, 0, -req.prompt_tokens)  # prefill slot freed
        nxt = self.maybe_start_prefill(now)
        return req, finish, nxt

    def on_decode_done(self, req: Request, now: float
                       ) -> Optional[Tuple[str, float]]:
        d_rem = 0
        out = req.output_tokens
        total = req.prompt_tokens + out
        if req.rid in self.decoding:
            del self.decoding[req.rid]
            self._decode_out_tokens -= out
            d_rem = -out
            self.rem -= out
        self.reserved_tokens -= total
        req.e2e = now - req.arrival
        lis = self.listener
        if lis is not None:
            lis(self, -total, d_rem)
        return self.maybe_start_prefill(now)
