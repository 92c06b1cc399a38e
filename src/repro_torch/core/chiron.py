"""Chiron baseline (arXiv:2501.08090) — hierarchical autoscaling.

Chiron keeps per-(model, region) *pools*: interactive, mixed, and batch
instances.  Its interactive autoscaler is backpressure-based and relies
on OFFLINE throughput profiles rather than online memory utilization:
required interactive capacity is arrival TPS divided by Θ × profiled
instance TPS (Θ = 0.6 per the SageServe evaluation); batch instances
scale on queue backlog vs. deadline slack; mixed instances serve batch
but are reclaimable for interactive bursts (we model them as the first
to be re-targeted).  This reproduces the qualitative behaviour the paper
reports: strong SLA attainment but substantially higher instance demand,
since Θ < 1 over-provisions against the offline profile and ignores
measured memory headroom.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from repro_torch.api.registry import register
from repro_torch.api.signals import BacklogSignal, Signal
from repro_torch.core.scaling import EndpointView, ScaleAction, ScalingPolicy

Key = Tuple[str, str]


class ChironPolicy(ScalingPolicy):
    name = "chiron"

    def __init__(self, theta: float = 0.6, profile_tps: Dict[str, float]
                 | None = None, init_interactive: int = 10,
                 init_mixed: int = 5, init_batch: int = 5,
                 cooldown: float = 60.0, min_instances: int = 2):
        self.theta = theta
        self.profile_tps = profile_tps or {}
        self.init = (init_interactive, init_mixed, init_batch)
        self.cooldown = cooldown
        self.min_instances = min_instances
        self._last: Dict[Key, float] = {}
        self.batch_backlog: Dict[Key, float] = {}   # queued NIW tokens

    def initial_instances(self) -> int:
        return sum(self.init)

    def note_backlog(self, model: str, region: str, tokens: float) -> None:
        self.batch_backlog[(model, region)] = tokens

    def observe(self, signal: Signal) -> None:
        if isinstance(signal, BacklogSignal):
            self.note_backlog(signal.model, signal.region, signal.tokens)

    def on_tick(self, views: List[EndpointView], now: float
                ) -> List[ScaleAction]:
        acts: List[ScaleAction] = []
        for v in views:
            key = (v.model, v.region)
            if now - self._last.get(key, -1e18) < self.cooldown:
                continue
            prof = self.profile_tps.get(v.model, 1000.0)
            # interactive requirement from offline profile + backpressure Θ
            req_inter = math.ceil(v.observed_tps / max(self.theta * prof,
                                                       1e-9))
            # batch requirement from backlog drain rate (24 h deadline)
            backlog = self.batch_backlog.get(key, 0.0)
            req_batch = math.ceil(backlog / max(prof * 3600.0, 1e-9))
            target = max(req_inter + req_batch + self.init[1],
                         self.min_instances)
            total = v.instances + v.pending
            if total != target:
                acts.append(ScaleAction(v.model, v.region, target - total,
                                        "chiron target"))
                self._last[key] = now
        return acts


@register("scaler", "chiron")
def _make_chiron(ctx, **kwargs) -> ChironPolicy:
    if kwargs.get("profile_tps") is None and ctx is not None:
        from repro_torch.sim.perfmodel import sustained_input_tps
        kwargs["profile_tps"] = {m: sustained_input_tps(p)
                                 for m, p in ctx.profiles.items()}
    return ChironPolicy(**kwargs)
