"""Declarative serving-stack specification.

A ``StackSpec`` is a plain-data description of one SageServe deployment:
which models run in which regions, which pluggable policies fill each
control-plane slot (scaler / scheduler / router / queue / planner, each
a ``PolicySpec`` of registry name + kwargs), the pool layout (unified vs
siloed), SLO tiers, and the simulator knobs.  It round-trips through
``to_dict``/``from_dict`` (JSON-able), validates against the registry,
and builds into a runnable ``ServingStack`` via
``repro_torch.api.build_stack`` — the single construction path used by
examples, benchmarks and tests.  Scenario sweeps are a loop over dicts::

    for d in grid:
        report = build_stack(StackSpec.from_dict(d)).simulate(trace)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

from repro_torch.api import registry
from repro_torch.control.cost import DEFAULT_DOLLARS_PER_HOUR
from repro_torch.sim.types import TTFT_SLA

SpecLike = Union[None, str, "PolicySpec", Mapping, Tuple[str, Mapping]]


def strict_from_dict(cls, d: Mapping):
    """Shared ``from_dict`` body for the declarative spec dataclasses:
    reject unknown keys loudly, then construct."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(
            f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Registry name + constructor kwargs for one pluggable component."""

    name: str
    kwargs: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def coerce(cls, v: SpecLike) -> Optional["PolicySpec"]:
        if v is None or isinstance(v, cls):
            return v
        if isinstance(v, str):
            return cls(v)
        if isinstance(v, Mapping):
            return cls(v["name"], dict(v.get("kwargs", {})))
        if isinstance(v, tuple) and len(v) == 2:
            return cls(v[0], dict(v[1]))
        raise TypeError(f"cannot interpret {v!r} as a PolicySpec")

    def to_dict(self) -> Dict:
        return {"name": self.name, "kwargs": dict(self.kwargs)}


@dataclasses.dataclass(frozen=True)
class OutageWindow:
    """One region-outage window in sim seconds: the region's capacity
    (live instances *and* spot pool) is unavailable in [start, end)."""

    region: str
    start: float
    end: float

    def to_dict(self) -> Dict:
        return {"region": self.region, "start": self.start,
                "end": self.end}


@dataclasses.dataclass
class ScenarioSpec:
    """Runtime stress scenario: region outage windows and per-region
    instance-capacity caps.  The simulator actuates outages (draining
    the region, refusing acquisitions); the forecast-aware planner sees
    the same windows ahead of time and evacuates placement before they
    hit.  Hour-indexed model-popularity shifts are a *workload*
    property — see ``repro_torch.sim.workload.PopularityShift``."""

    outages: Tuple[OutageWindow, ...] = ()
    region_caps: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.outages = tuple(
            o if isinstance(o, OutageWindow) else OutageWindow(**o)
            for o in self.outages)

    def validate(self) -> "ScenarioSpec":
        for o in self.outages:
            if o.end <= o.start:
                raise ValueError(
                    f"ScenarioSpec outage for {o.region!r}: end {o.end} "
                    f"must be past start {o.start}")
        for rg, cap in self.region_caps.items():
            if cap <= 0:
                raise ValueError(
                    f"ScenarioSpec.region_caps[{rg!r}] must be positive")
        return self

    def to_dict(self) -> Dict:
        return {"outages": [o.to_dict() for o in self.outages],
                "region_caps": dict(self.region_caps)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "ScenarioSpec":
        return strict_from_dict(cls, d)

    @classmethod
    def coerce(cls, v) -> Optional["ScenarioSpec"]:
        if v is None or isinstance(v, cls):
            return v
        if isinstance(v, Mapping):
            return cls.from_dict(v)
        raise TypeError(f"cannot interpret {v!r} as a ScenarioSpec")


_POLICY_SLOTS = ("scaler", "scheduler", "router", "queue", "planner")


@dataclasses.dataclass
class StackSpec:
    """Everything needed to assemble one serving stack."""

    models: Tuple[str, ...]
    regions: Tuple[str, ...]

    # pluggable policy slots (default_factory: PolicySpec.kwargs is a
    # mutable dict, a shared default instance would leak edits across
    # every StackSpec)
    scaler: PolicySpec = dataclasses.field(
        default_factory=lambda: PolicySpec("reactive"))
    scheduler: PolicySpec = dataclasses.field(
        default_factory=lambda: PolicySpec("fcfs"))
    router: PolicySpec = dataclasses.field(
        default_factory=lambda: PolicySpec("threshold"))
    queue: Optional[PolicySpec] = dataclasses.field(
        default_factory=lambda: PolicySpec("niw"))
    planner: Optional[PolicySpec] = None

    # scenario & placement --------------------------------------------------
    # stress scenario (region outages, per-region capacity caps);
    # None → the default steady-state run
    scenario: Optional[ScenarioSpec] = None
    # initial model placement: model → regions it is deployed in;
    # None → every model in every region (the original baseline)
    placement: Optional[Dict[str, Tuple[str, ...]]] = None

    # pool layout -----------------------------------------------------------
    siloed: bool = False                  # separate IW/NIW pools
    initial_instances: Optional[int] = None  # per (model, region); None →
    #                                          scaler's own initial sizing
    siloed_iw: int = 16
    siloed_niw: int = 4
    spot_spare: int = 10

    # SLO tiers (TTFT seconds per tier; NIW has a batch deadline instead)
    slo_ttft: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(TTFT_SLA))

    # control-loop cadence & thresholds -------------------------------------
    tick: float = 15.0
    sample_every: float = 60.0
    qm_signal_thresh: float = 0.6
    tps_window: float = 60.0
    drain_grace: float = 6 * 3600.0
    history_lookback: float = 8 * 86400.0   # TPS history retention (s)

    # dollar accounting (paper §7.2.1: α = $98.32/h per serving VM);
    # cost_rates overrides per model (a proxy for its GPU type / VM SKU)
    cost_alpha: float = DEFAULT_DOLLARS_PER_HOUR
    cost_rates: Dict[str, float] = dataclasses.field(default_factory=dict)

    # retry/backoff when an endpoint has zero live instances
    retry_base: float = 5.0
    retry_cap: float = 160.0
    max_retries: int = 12

    def __post_init__(self):
        self.models = tuple(self.models)
        self.regions = tuple(self.regions)
        for slot in _POLICY_SLOTS:
            setattr(self, slot, PolicySpec.coerce(getattr(self, slot)))
        self.scenario = ScenarioSpec.coerce(self.scenario)
        if self.placement is not None:
            self.placement = {m: tuple(rgs)
                              for m, rgs in dict(self.placement).items()}

    # -------------------------------------------------------------- validate
    def validate(self) -> "StackSpec":
        if not self.models:
            raise ValueError("StackSpec.models must be non-empty")
        if not self.regions:
            raise ValueError("StackSpec.regions must be non-empty")
        for slot in _POLICY_SLOTS:
            spec = getattr(self, slot)
            if spec is None:
                if slot in ("scaler", "scheduler", "router"):
                    raise ValueError(f"StackSpec.{slot} is required")
                continue
            if spec.name.lower() not in registry.known(slot):
                raise KeyError(
                    f"StackSpec.{slot}: no {slot} registered under "
                    f"{spec.name!r}; known: "
                    f"{', '.join(registry.known(slot))}")
        if self.siloed and (self.siloed_iw <= 0 or self.siloed_niw <= 0):
            raise ValueError("siloed pools need positive instance counts")
        if (self.initial_instances is not None
                and self.initial_instances <= 0):
            raise ValueError("initial_instances must be positive")
        for knob in ("tick", "sample_every", "tps_window", "retry_base",
                     "history_lookback", "cost_alpha"):
            if getattr(self, knob) <= 0:
                raise ValueError(f"StackSpec.{knob} must be positive")
        for model, rate in self.cost_rates.items():
            if rate <= 0:
                raise ValueError(
                    f"cost_rates[{model!r}] must be positive")
        if not 0.0 < self.qm_signal_thresh <= 1.0:
            raise ValueError("qm_signal_thresh must be in (0, 1]")
        for tier, sla in self.slo_ttft.items():
            if sla <= 0:
                raise ValueError(f"slo_ttft[{tier!r}] must be positive")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.scenario is not None:
            self.scenario.validate()
            for o in self.scenario.outages:
                if o.region not in self.regions:
                    raise ValueError(
                        f"scenario outage region {o.region!r} not in "
                        f"StackSpec.regions")
            for rg in self.scenario.region_caps:
                if rg not in self.regions:
                    raise ValueError(
                        f"scenario region_caps region {rg!r} not in "
                        f"StackSpec.regions")
        if self.placement is not None:
            for m, rgs in self.placement.items():
                if m not in self.models:
                    raise ValueError(
                        f"placement model {m!r} not in StackSpec.models")
                if not rgs:
                    raise ValueError(
                        f"placement[{m!r}] must name >= 1 region")
                for rg in rgs:
                    if rg not in self.regions:
                        raise ValueError(
                            f"placement[{m!r}] region {rg!r} not in "
                            f"StackSpec.regions")
        return self

    # ------------------------------------------------------------- dict I/O
    def to_dict(self) -> Dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (PolicySpec, ScenarioSpec)):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            elif isinstance(v, dict):
                v = {k: (list(x) if isinstance(x, tuple) else x)
                     for k, x in v.items()}
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: Mapping) -> "StackSpec":
        return strict_from_dict(cls, d)
