"""The hourly control-plane ``Plan``: one object co-optimizing scaling,
cross-region routing and model placement (paper §5–§6).

A ``GlobalPlanner`` emits a ``Plan`` every hour: per-(model, region)
instance **targets** (the ILP's n+δ), the peak **forecasts** they were
derived from, an optional ``RoutingPlan`` of cross-region traffic
fractions (the ILP's spill variables ω), an optional ``PlacementPlan``
of which models are deployed where (the ILP's y binaries, with
per-decision lead times), and the solver's objective in dollars.
Scalers actuate the targets at their own pace; a plan-aware router
splits traffic by the fractions until the plan goes stale; the cluster
actuates placement actions at their staged ``effective_at`` times.

Plain data — no JAX, no simulator imports — so every layer (api, sim,
benchmarks, live serving) can pass plans around freely.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Mapping, Optional, Tuple

Key = Tuple[str, str]  # (model, region)


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    """Cross-region traffic split: ``fractions[(model, home_region)]``
    maps each serving region to the fraction of the home region's
    demand it should absorb (ω_{i,j→j'} in the §5 ILP extension).
    Fractions per key are non-negative and sum to 1."""

    fractions: Dict[Key, Dict[str, float]]

    def cumulative(self, key: Key) -> Optional[List[Tuple[float, str]]]:
        """Cumulative split points for hash-based routing: a sorted list
        of (cum_fraction, region), home region first so that sub-ε
        hash values always stay home."""
        fr = self.fractions.get(key)
        if not fr:
            return None
        home = key[1]
        order = sorted(fr, key=lambda rg: (rg != home, rg))
        out, cum = [], 0.0
        for rg in order:
            f = fr[rg]
            if f <= 0.0:
                continue
            cum += f
            out.append((cum, rg))
        if not out:
            return None
        # guard against float drift: the last split point covers 1.0
        last_cum, last_rg = out[-1]
        out[-1] = (max(last_cum, 1.0), last_rg)
        return out

    def validate(self, tol: float = 1e-6) -> None:
        for key, fr in self.fractions.items():
            total = sum(fr.values())
            if any(f < -tol for f in fr.values()):
                raise ValueError(f"RoutingPlan[{key}]: negative fraction")
            if abs(total - 1.0) > 1e-3:
                raise ValueError(
                    f"RoutingPlan[{key}]: fractions sum to {total}, not 1")


@dataclasses.dataclass(frozen=True)
class PlacementAction:
    """One staged model-placement decision.

    Placement has higher lead times than VM scaling (§5): a deploy
    issued at ``issued_at`` is only live at ``effective_at = issued_at
    + lead_time`` (warm spot retag ≪ cold local load ≪ remote weight
    fetch).  Undeploys drain immediately (lead 0) and retag the freed
    spot VMs with the model for cheap future swaps."""

    model: str
    region: str
    deploy: bool          # True → deploy, False → undeploy (drain)
    issued_at: float      # plan time (sim s)
    lead_time: float      # actuation lead (s); 0 for undeploys

    @property
    def effective_at(self) -> float:
        return self.issued_at + self.lead_time

    def to_dict(self) -> Dict:
        return {"model": self.model, "region": self.region,
                "deploy": self.deploy, "issued_at": self.issued_at,
                "lead_time": self.lead_time}


@dataclasses.dataclass
class PlacementPlan:
    """Which models are deployed in which region (the ILP's y_{m,j}
    binaries) plus the staged transition actions.  ``placed`` is the
    *target* placement for the plan's hour; keys absent from it default
    to placed (the all-models-everywhere baseline)."""

    placed: Dict[Key, bool]
    actions: List[PlacementAction] = dataclasses.field(
        default_factory=list)

    def is_placed(self, model: str, region: str) -> bool:
        return self.placed.get((model, region), True)

    def to_dict(self) -> Dict:
        """JSON-safe form: tuple keys become [model, region, placed]
        triples, actions nest their own dicts."""
        return {"placed": [[m, r, bool(v)] for (m, r), v
                           in self.placed.items()],
                "actions": [a.to_dict() for a in self.actions]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "PlacementPlan":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise KeyError(
                f"PlacementPlan.from_dict: unknown keys {sorted(unknown)}")
        return cls(
            placed={(m, r): bool(v) for m, r, v in d.get("placed", ())},
            actions=[a if isinstance(a, PlacementAction)
                     else PlacementAction(**a)
                     for a in d.get("actions", ())])

    def validate(self) -> None:
        for a in self.actions:
            if a.lead_time < 0:
                raise ValueError(
                    f"PlacementAction[{a.model},{a.region}]: negative "
                    f"lead_time {a.lead_time}")
            want = self.placed.get((a.model, a.region))
            if want is not None and want != a.deploy:
                raise ValueError(
                    f"PlacementAction[{a.model},{a.region}]: action "
                    f"deploy={a.deploy} contradicts placed={want}")


@dataclasses.dataclass(frozen=True)
class PlacementState:
    """What the planner needs to price placement transitions: the
    cluster's current deployments, which regions hold the model's
    weights locally, warm (retag-window) spot VM tags, and regions
    currently down.  Fed to planners that advertise the duck-typed
    ``set_placement_state`` capability before each hourly ``plan``."""

    placed: FrozenSet[Key] = frozenset()
    weights_local: FrozenSet[Key] = frozenset()
    warm_spot: Dict[Key, int] = dataclasses.field(default_factory=dict)
    down_regions: FrozenSet[str] = frozenset()


@dataclasses.dataclass
class Plan:
    """One hourly control decision: scaling targets + routing split +
    staged model placement."""

    t: float                                  # plan creation time (sim s)
    targets: Dict[Key, int]                   # ILP n+δ per (model, region)
    forecasts: Dict[Key, float]               # peak TPS the ILP planned for
    routing: Optional[RoutingPlan] = None     # None → router's own policy
    placement: Optional[PlacementPlan] = None  # None → all models placed
    horizon: float = 3600.0                   # validity window (s)
    cost_estimate: float = 0.0                # ILP objective ($)
    status: str = ""                          # ILP solver status

    def stale(self, now: float, slack: float = 2.0) -> bool:
        """A plan past ``slack`` horizons is stale: consumers must fall
        back to their myopic policies rather than act on old targets."""
        return now > self.t + slack * self.horizon
