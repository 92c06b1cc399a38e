"""Scaling policies (§4, §6.4): Siloed / Reactive / LT-I / LT-U / LT-UA.

Policies are driven by the simulator (or a live control plane) through a
narrow view of each (model, region) endpoint::

    EndpointView(model, region, util, instances, pending, observed_tps)

and return ScaleActions.  The LT-* policies additionally receive hourly
ILP targets from the controller (``set_targets``) and, for LT-UA, the
ARIMA forecast against which observed traffic is compared in the last 20
minutes of the hour.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.api.registry import register
from repro_torch.api.signals import Signal

Key = Tuple[str, str]  # (model, region)


@dataclasses.dataclass(slots=True)
class EndpointView:
    model: str
    region: str
    util: float            # effective memory utilization, 0..1
    instances: int         # live instances
    pending: int           # instances still provisioning
    observed_tps: float    # input TPS over the last window
    pool: str = "unified"  # siloed policies: "IW" | "NIW"


@dataclasses.dataclass(slots=True)
class ScaleAction:
    model: str
    region: str
    delta: int
    reason: str
    pool: str = "unified"


class ScalingPolicy:
    name = "base"

    def on_request(self, view: EndpointView, now: float) -> List[ScaleAction]:
        return []

    def on_tick(self, views: List[EndpointView], now: float
                ) -> List[ScaleAction]:
        return []

    def set_targets(self, targets: Dict[Key, int],
                    forecasts: Dict[Key, float], now: float) -> List[ScaleAction]:
        return []

    def observe(self, signal: Signal) -> None:
        """Consume a control-plane signal (backlog, utilization, ...).
        Policies that don't care inherit this no-op."""


class ReactivePolicy(ScalingPolicy):
    """Current O365 deployment (§4): per-request trigger on effective
    memory utilization with a cooldown.  Works for both Unified (one pool)
    and Siloed (per-pool views) deployments."""

    name = "reactive"

    def __init__(self, up: float = 0.7, down: float = 0.3,
                 cooldown: float = 15.0, min_instances: int = 2):
        self.up, self.down, self.cooldown = up, down, cooldown
        self.min_instances = min_instances
        self._last: Dict[Tuple[Key, str], float] = {}

    def wants_request_view(self, model: str, region: str, pool: str,
                           now: float) -> bool:
        """Optional fast-path capability (duck-typed by the simulator):
        within the cooldown the per-request hook can never act, so the
        caller may skip building the EndpointView entirely."""
        return now - self._last.get(((model, region), pool),
                                    -1e18) >= self.cooldown

    def on_request(self, v: EndpointView, now: float) -> List[ScaleAction]:
        key = ((v.model, v.region), v.pool)
        if now - self._last.get(key, -1e18) < self.cooldown:
            return []
        total = v.instances + v.pending
        if v.util > self.up:
            self._last[key] = now
            return [ScaleAction(v.model, v.region, +1, "util>up", v.pool)]
        if v.util < self.down and total > self.min_instances:
            self._last[key] = now
            return [ScaleAction(v.model, v.region, -1, "util<down", v.pool)]
        return []


class LTPolicy(ScalingPolicy):
    """Long-term predictive scaling driven by hourly ILP targets.

    mode:
      "I"  — Immediate: jump to the target when it arrives.
      "U"  — Deferred on utilization: move toward the target only when the
             up/down thresholds are actually breached.
      "UA" — LT-U + ARIMA-gap escape: in the last `ua_window` of the hour,
             keep scaling past the target when observed TPS ≥ ua_hi× the
             forecast (underestimate) or ≤ ua_lo× (overestimate).
    """

    def __init__(self, mode: str = "UA", up: float = 0.7, down: float = 0.3,
                 cooldown: float = 15.0, min_instances: int = 2,
                 ua_hi: float = 5.0, ua_lo: float = 0.5,
                 hour: float = 3600.0, ua_window: float = 1200.0):
        assert mode in ("I", "U", "UA")
        self.mode = mode
        self.name = f"lt-{mode.lower()}"
        self.up, self.down, self.cooldown = up, down, cooldown
        self.min_instances = min_instances
        self.ua_hi, self.ua_lo = ua_hi, ua_lo
        self.hour, self.ua_window = hour, ua_window
        self.targets: Dict[Key, int] = {}
        self.forecasts: Dict[Key, float] = {}
        self._last: Dict[Key, float] = {}
        self._hour_start: float = 0.0
        self._totals: Dict[Key, int] = {}   # live+pending seen on_tick

    # ------------------------------------------------------------- hourly
    def set_targets(self, targets: Dict[Key, int],
                    forecasts: Dict[Key, float], now: float
                    ) -> List[ScaleAction]:
        self.targets = dict(targets)
        self.forecasts = dict(forecasts)
        self._hour_start = now
        if self.mode != "I":
            return []
        # LT-I is *Immediate*: jump to the target the moment it arrives
        # instead of deferring actuation to the next tick (a full tick
        # of lag every hour).  Counts come from the last tick's views
        # (at most one tick stale); on_tick keeps reconciling drift.
        acts: List[ScaleAction] = []
        for key, tgt in self.targets.items():
            total = self._totals.get(key)
            if total is None:
                continue  # no view yet: first on_tick will actuate
            tgt = max(tgt, self.min_instances)
            if total != tgt:
                acts.append(ScaleAction(key[0], key[1], tgt - total,
                                        "lt-i target"))
                self._totals[key] = tgt
        return acts

    # ------------------------------------------------------------- ticks
    def on_tick(self, views: List[EndpointView], now: float
                ) -> List[ScaleAction]:
        acts: List[ScaleAction] = []
        for v in views:
            key = (v.model, v.region)
            total = v.instances + v.pending
            self._totals[key] = total
            if key not in self.targets:
                continue
            target = max(self.targets[key], self.min_instances)
            if self.mode == "I":
                if total != target:
                    acts.append(ScaleAction(v.model, v.region,
                                            target - total, "lt-i target"))
                    # record the actuated count, or an hourly set_targets
                    # landing before the next tick re-issues this delta
                    self._totals[key] = target
                continue
            if now - self._last.get(key, -1e18) < self.cooldown:
                continue
            if v.util > self.up and total < target:
                acts.append(ScaleAction(v.model, v.region, +1, "lt-u up"))
                self._last[key] = now
            elif v.util < self.down and total > max(target,
                                                    self.min_instances):
                acts.append(ScaleAction(v.model, v.region, -1, "lt-u down"))
                self._last[key] = now
            elif self.mode == "UA" and self._in_ua_window(now):
                fc = max(self.forecasts.get(key, 0.0), 1e-9)
                if (total >= target and v.observed_tps >= self.ua_hi * fc
                        and v.util > self.up):
                    acts.append(ScaleAction(v.model, v.region, +1,
                                            "ua underestimate"))
                    self._last[key] = now
                elif (total <= target and total > self.min_instances
                        and v.observed_tps <= self.ua_lo * fc):
                    acts.append(ScaleAction(v.model, v.region, -1,
                                            "ua overestimate"))
                    self._last[key] = now
        return acts

    def _in_ua_window(self, now: float) -> bool:
        return (now - self._hour_start) >= (self.hour - self.ua_window)


def make_policy(name: str, **kw) -> ScalingPolicy:
    name = name.lower()
    if name in ("reactive", "siloed"):
        return ReactivePolicy(**kw)
    if name == "lt-i":
        return LTPolicy(mode="I", **kw)
    if name == "lt-u":
        return LTPolicy(mode="U", **kw)
    if name == "lt-ua":
        return LTPolicy(mode="UA", **kw)
    raise KeyError(name)


for _name in ("reactive", "siloed", "lt-i", "lt-u", "lt-ua"):
    register("scaler", _name)(
        lambda ctx, _n=_name, **kw: make_policy(_n, **kw))
