"""Structural protocols for the control plane (§5–§6 of the paper).

The simulator's event core and the real-JAX serving engine both program
against these shapes, never against concrete classes: any object that
satisfies the protocol plugs in via the registry without touching the
event loop.  Concrete built-ins live in ``repro_torch.core`` (ReactivePolicy,
LTPolicy, ChironPolicy, QueueManager, SageServeController, ...).
"""
from __future__ import annotations

from typing import (Dict, List, Mapping, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np

from repro_torch.api.plan import Plan
from repro_torch.api.signals import Signal

Key = Tuple[str, str]  # (model, region)


@runtime_checkable
class RequestLike(Protocol):
    """The shared request shape: what scheduling, queueing and routing
    need, satisfied by both the simulator's ``repro_torch.sim.types.Request``
    and the serving engine's ``ServeRequest``."""

    rid: int
    model: str
    region: str
    tier: str                 # "IW-F" | "IW-N" | "NIW"
    arrival: float
    prompt_tokens: int
    output_tokens: int
    ttft_deadline: float
    deadline: float
    priority: int             # NIW: 1 default, 0 once promoted


@runtime_checkable
class Scheduler(Protocol):
    """Instance-level admission order: a pure ordering function over the
    waiting queue (§6.5)."""

    def __call__(self, requests: Sequence[RequestLike], now: float
                 ) -> List[RequestLike]: ...


@runtime_checkable
class Router(Protocol):
    """Global IW routing (§6.1): pick the serving region for a request
    given per-region endpoint utilization and the preference order
    (home region first)."""

    def route(self, region_utils: Mapping[str, float],
              preference: Sequence[str]) -> str: ...


@runtime_checkable
class Scaler(Protocol):
    """Scaling policy (§4, §6.4).  All hooks are optional-behaviour: the
    base implementations return no actions / ignore signals."""

    def on_request(self, view, now: float) -> List: ...

    def on_tick(self, views: List, now: float) -> List: ...

    def set_targets(self, targets: Dict[Key, int],
                    forecasts: Dict[Key, float], now: float) -> List: ...

    def observe(self, signal: Signal) -> None: ...


@runtime_checkable
class QueuePolicy(Protocol):
    """NIW queue manager (§6.2): park background requests and drip-feed
    them on spare-capacity signals."""

    def submit(self, request: RequestLike) -> None: ...

    def depth(self, model: Optional[str] = None) -> int: ...

    def backlog_tokens(self, model: str) -> float: ...

    def on_capacity_signal(self, model: str, region: str, util: float,
                           now: float, live_instances: int = 1
                           ) -> List[RequestLike]: ...

    def force_release_expiring(self, now: float) -> List[RequestLike]: ...


@runtime_checkable
class Forecaster(Protocol):
    """Traffic forecaster (§6.3): fit on a TPS history, forecast the
    next horizon windows."""

    def fit(self, series: Sequence[float]) -> "Forecaster": ...

    def forecast(self, horizon: int) -> np.ndarray: ...


@runtime_checkable
class GlobalPlanner(Protocol):
    """Hourly global planner (§5–§6.3): forecast + ILP → one ``Plan``
    of per-(model, region) instance targets (actuated by the Scaler at
    its own pace), optional cross-region routing fractions (consumed by
    a plan-aware Router), and optional staged model-placement actions
    (actuated by the cluster at each action's ``effective_at``).
    Planners may additionally advertise the duck-typed
    ``set_placement_state(state)`` capability to receive the cluster's
    deployment/warmth snapshot before each ``plan`` call.  Legacy
    planners returning a bare ``(targets, forecasts)`` tuple are still
    accepted by the simulator's hourly adapter."""

    def plan(self, now: float, instances: Dict[Key, int],
             history: Dict[Key, np.ndarray],
             niw_last_hour_tps: Dict[Key, float]) -> Plan: ...
