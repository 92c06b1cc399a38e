"""Routing logic (§6.1): global region routing, endpoint JSQ, instance
pick, and plan-aware routing driven by the hourly ILP's spill fractions.

Global IW routing: pick the first preferred region whose effective memory
utilization is below ``threshold``; if none qualifies, the least-utilized
region.  Endpoint routing: least-loaded deployment by effective memory;
instance routing: Join-the-Shortest-Queue on remaining tokens.

``PlanAwareRouter`` consumes the hourly ``Plan``'s routing fractions
deterministically (hash-based splitting on the request id) and degrades
to the util-threshold policy whenever the plan is stale, has no entry
for the key, or the planned region is saturated/draining.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

from repro_torch.api.plan import Plan
from repro_torch.api.registry import register


def route_global(region_utils: Dict[str, float],
                 preference: Sequence[str],
                 threshold: float = 0.7) -> str:
    """region_utils: effective mem util per candidate region.

    Preferred regions absent from ``region_utils`` (no endpoint deployed
    there) are skipped.  When no utilization data exists at all, the
    home region — the first preference — is the documented fallback.
    """
    for r in preference:
        if r in region_utils and region_utils[r] < threshold:
            return r
    if not region_utils:
        if not preference:
            raise ValueError("route_global: no candidate regions and no "
                             "preference to fall back to")
        return preference[0]
    return min(region_utils, key=region_utils.get)


def route_jsq(instance_loads: Dict[str, float]) -> str:
    """instance id -> remaining tokens to process; pick the minimum."""
    return min(instance_loads, key=lambda k: (instance_loads[k], k))


def pick_endpoint(endpoint_utils: Dict[str, float]) -> str:
    """Least effective-memory-utilized deployment endpoint in a region."""
    return min(endpoint_utils, key=lambda k: (endpoint_utils[k], k))


class ThresholdRouter:
    """``Router``-protocol wrapper around ``route_global``."""

    def __init__(self, threshold: float = 0.7):
        self.threshold = threshold

    def route(self, region_utils: Mapping[str, float],
              preference: Sequence[str]) -> str:
        return route_global(dict(region_utils), preference, self.threshold)

    def home_threshold(self) -> float:
        """Optional fast-path capability (duck-typed by the simulator):
        a utilization bound below which the first preferred region always
        wins, letting callers skip assembling the full utils map."""
        return self.threshold


# Knuth multiplicative hash: spreads consecutive request ids uniformly
# over [0, 1) while staying deterministic across runs and processes
# (Python's hash() is salted per process).
_HASH_MULT = 2654435761
_HASH_MOD = 1 << 32


def _rid_unit(rid: int) -> float:
    return ((rid * _HASH_MULT) % _HASH_MOD) / _HASH_MOD


class PlanAwareRouter:
    """Deterministic plan-driven region splitting with a threshold
    fallback.

    The hourly planner pushes a ``Plan`` via ``update_plan`` (a
    capability the simulator duck-types, like ``home_threshold``).  Each
    request hashes its id to a point in [0, 1) and lands in the region
    whose cumulative fraction bucket contains it — the realized split
    converges to the ILP's ω fractions without any shared mutable state,
    so routing is reproducible and order-independent.

    Fallback to ``route_global`` (util threshold) when:
    - no plan has arrived yet, or the plan is stale (``stale_after``
      horizons old — e.g. the controller died);
    - the plan has no fractions for this (model, home region);
    - the chosen region is absent from ``region_utils`` (endpoint
      drained away) or its utilization is at/above ``overload_util``.
    """

    def __init__(self, threshold: float = 0.7, stale_after: float = 2.0,
                 overload_util: float = 0.98):
        self.threshold = threshold
        self.stale_after = stale_after
        self.overload_util = overload_util
        self.plan: Optional[Plan] = None
        self._cum = {}           # (model, home) -> [(cum_frac, region)]
        self.plan_routed = 0     # requests split by the plan
        self.fallback_routed = 0

    # ------------------------------------------------------------ plan feed
    def update_plan(self, plan: Plan, now: float) -> None:
        self.plan = plan
        self._cum = {}
        if plan.routing is not None:
            for key in plan.routing.fractions:
                cum = plan.routing.cumulative(key)
                if cum:
                    self._cum[key] = cum

    # -------------------------------------------------------------- routing
    def route(self, region_utils: Mapping[str, float],
              preference: Sequence[str]) -> str:
        """Protocol-compliant entry point without a request identity:
        pure threshold fallback (used by callers that don't advertise
        per-request routing)."""
        return route_global(dict(region_utils), preference, self.threshold)

    def route_request(self, request, region_utils: Mapping[str, float],
                      preference: Sequence[str]) -> str:
        """Per-request capability (duck-typed by the simulator): split
        deterministically by the plan's ω fractions."""
        plan = self.plan
        if plan is None or plan.stale(request.arrival, self.stale_after):
            self.fallback_routed += 1
            return self.route(region_utils, preference)
        home = preference[0] if preference else request.region
        cum = self._cum.get((request.model, home))
        if cum is None:
            self.fallback_routed += 1
            return self.route(region_utils, preference)
        u = _rid_unit(request.rid)
        region = cum[-1][1]
        for c, rg in cum:
            if u < c:
                region = rg
                break
        util = region_utils.get(region)
        if util is None or util >= self.overload_util:
            # planned region drained away or saturated: myopic rescue
            self.fallback_routed += 1
            return self.route(region_utils, preference)
        self.plan_routed += 1
        return region


@register("router", "threshold")
def _make_threshold_router(ctx, **kwargs) -> ThresholdRouter:
    return ThresholdRouter(**kwargs)


@register("router", "plan")
def _make_plan_router(ctx, **kwargs) -> PlanAwareRouter:
    return PlanAwareRouter(**kwargs)
