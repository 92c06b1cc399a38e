"""Deterministic scenario fuzzer: a seeded grammar over stress axes.

The fuzzer turns "the autoscaler handles many scenarios" from an
anecdote into a tracked surface: from one integer seed it composes
**scenarios** — a workload family crossed with stress axes (regional
outage, model-popularity shift, synthetic burst, spot-preemption storm,
traffic-scale jitter) — into an explicit-variant ``ExperimentSpec``
that runs every registered policy stack over the *identical* trace on
the vector engine, then scores the per-scenario dollar/SLA frontier
(which stacks are dominated, deltas vs the ``sageserve`` default).

Everything is derived via ``derive_seed`` + ``np.random.default_rng``,
so the same ``FuzzSpec`` always produces the same scenario grid, the
same traces, and the same frontier — which is what lets
``BENCH_fuzz.json`` act as a regression baseline in ``check.sh``.

Grammar (per composed scenario)::

    scenario  := family × axes            # >= 2 axes always active
    axes      := outage? popshift? burst? preempt? scale-jitter
    outage    := 1-3h capacity loss in one region, mid-trace
    popshift  := one model's popularity ×{0, 3, 8} for 2-6h
    burst     := §7.2.7-style 4-10× arrival mult for 1-2 hours
    preempt   := PreemptionStorm(4-10 events, 8-20 min mean)
    scale     := log-uniform trace-volume jitter, e^±scale_jitter

Axis placement mirrors production coupling: workload-side axes
(popshift, burst, scale) land on the ``WorkloadSpec``; capacity-side
axes (outage, preemption windows) land on the ``ScenarioSpec`` carried
by every stack of that scenario — the explicit-Variant form exists
precisely because these axes are coupled.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.api.experiment import (ExperimentSpec, ResultSet, Variant,
                                        derive_seed)
from repro_torch.api.spec import (OutageWindow, PolicySpec, ScenarioSpec,
                                  StackSpec, strict_from_dict)
from repro_torch.sim.types import TIER_IWF, TIER_IWN, TIER_NIW
from repro_torch.sim.workload import PopularityShift, WorkloadSpec
from repro_torch.workloads.families import (FAMILIES, PreemptionStorm,
                                            family_workload)

BASELINE_STACK = "sageserve"

#: policy stacks the fuzzer can exercise (self-contained — the fuzzer
#: must be importable without the benchmarks package on sys.path)
STACK_NAMES = ("sageserve", "reactive", "lt-ua", "chiron")


def _planner(routing: bool) -> PolicySpec:
    kw = {"min_instances": 2, "epsilon": 0.8, "fit_steps": 40,
          "theta_headroom": 0.7}
    if routing:
        kw["use_routing"] = True
    return PolicySpec("sageserve", kw)


def fuzz_stack(name: str, models, regions,
               scenario: Optional[ScenarioSpec] = None) -> StackSpec:
    """One registered policy stack, sized for fuzzer-scale traces
    (small ``scale`` ⇒ small fleets, short drain grace)."""
    common = dict(models=tuple(models), regions=tuple(regions),
                  scenario=scenario, spot_spare=8,
                  drain_grace=2 * 3600.0)
    if name == "sageserve":
        return StackSpec(scaler="lt-ua", planner=_planner(routing=True),
                         router="plan", initial_instances=3, **common)
    if name == "lt-ua":
        return StackSpec(scaler="lt-ua", planner=_planner(routing=False),
                         initial_instances=3, **common)
    if name == "reactive":
        return StackSpec(scaler="reactive", initial_instances=3, **common)
    if name == "chiron":
        return StackSpec(
            scaler=PolicySpec("chiron", {
                "theta": 0.6, "init_interactive": 2, "init_mixed": 1,
                "init_batch": 1}),
            initial_instances=None, **common)
    raise KeyError(f"unknown fuzz stack {name!r}; known: "
                   f"{', '.join(STACK_NAMES)}")


# --------------------------------------------------------------------- specs
@dataclasses.dataclass
class FuzzSpec:
    """The whole fuzz campaign, reproducible from this spec alone."""

    seed: int = 0
    days: float = 1.0
    scale: float = 0.02
    families: Tuple[str, ...] = tuple(sorted(FAMILIES))
    include_pure: bool = True        # one un-stressed run per family
    n_composed: int = 6              # family × >=2-axis compositions
    stacks: Tuple[str, ...] = ("sageserve", "reactive")
    # per-axis activation probabilities (each composed scenario is
    # forced to >= 2 active axes regardless)
    p_outage: float = 0.5
    p_popshift: float = 0.5
    p_burst: float = 0.4
    p_preempt: float = 0.35
    scale_jitter: float = 0.3        # log-uniform volume jitter, e^±j

    def __post_init__(self):
        self.families = tuple(self.families)
        self.stacks = tuple(self.stacks)

    def validate(self) -> "FuzzSpec":
        if self.days <= 0 or self.scale <= 0:
            raise ValueError("FuzzSpec.days and .scale must be positive")
        if self.n_composed < 0:
            raise ValueError("FuzzSpec.n_composed must be >= 0")
        if not self.families:
            raise ValueError("FuzzSpec.families must be non-empty")
        for fname in self.families:
            if fname not in FAMILIES:
                raise KeyError(
                    f"FuzzSpec.families: no workload family named "
                    f"{fname!r}; known: {', '.join(sorted(FAMILIES))}")
        if not self.stacks:
            raise ValueError("FuzzSpec.stacks must be non-empty")
        for s in self.stacks:
            if s not in STACK_NAMES:
                raise KeyError(
                    f"FuzzSpec.stacks: unknown stack {s!r}; known: "
                    f"{', '.join(STACK_NAMES)}")
        for p in ("p_outage", "p_popshift", "p_burst", "p_preempt"):
            if not 0.0 <= getattr(self, p) <= 1.0:
                raise ValueError(f"FuzzSpec.{p} must be in [0, 1]")
        if self.scale_jitter < 0:
            raise ValueError("FuzzSpec.scale_jitter must be >= 0")
        return self

    def to_dict(self) -> Dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = list(v) if isinstance(v, tuple) else v
        return out

    @classmethod
    def from_dict(cls, d: Mapping) -> "FuzzSpec":
        return strict_from_dict(cls, d)


@dataclasses.dataclass
class FuzzScenario:
    """One fully-resolved scenario: a workload (family + workload-side
    axes baked in) plus the capacity-side ``ScenarioSpec`` every stack
    of this scenario runs under, and the human-readable axis record."""

    name: str
    family: str
    workload: WorkloadSpec
    scenario: Optional[ScenarioSpec] = None
    axes: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"name": self.name, "family": self.family,
                "workload": self.workload.to_dict(),
                "scenario": (None if self.scenario is None
                             else self.scenario.to_dict()),
                "axes": dict(self.axes)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "FuzzScenario":
        d = dict(d)
        if d.get("workload") is not None and not isinstance(
                d["workload"], WorkloadSpec):
            d["workload"] = WorkloadSpec.from_dict(d["workload"])
        if d.get("scenario") is not None and not isinstance(
                d["scenario"], ScenarioSpec):
            d["scenario"] = ScenarioSpec.from_dict(d["scenario"])
        return strict_from_dict(cls, d)


# ------------------------------------------------------------------- grammar
def _storm_scenario(fam, wl: WorkloadSpec,
                    extra: Tuple[Tuple[str, float, float], ...] = ()
                    ) -> Optional[ScenarioSpec]:
    """Materialize a family's preemption storm (plus any fuzz-axis
    windows) into the ScenarioSpec the simulator actuates.  Windows are
    merged per region — overlapping OutageStart/OutageEnd events for
    one region would double-fire."""
    wins: List[Tuple[str, float, float]] = list(extra)
    if fam is not None and fam.preemption is not None:
        wins.extend(fam.preemption.to_windows(
            wl.days, tuple(wl.regions), wl.seed))
    if not wins:
        return None
    per_region: Dict[str, List[List[float]]] = {}
    for rg, s, e in sorted(wins, key=lambda w: (w[0], w[1])):
        lst = per_region.setdefault(rg, [])
        if lst and s <= lst[-1][1]:
            lst[-1][1] = max(lst[-1][1], e)
        else:
            lst.append([s, e])
    return ScenarioSpec(outages=tuple(
        OutageWindow(rg, s, e) for rg in sorted(per_region)
        for s, e in per_region[rg]))


def fuzz_scenarios(spec: FuzzSpec) -> Tuple[FuzzScenario, ...]:
    """Expand the seeded grammar into the concrete scenario grid."""
    spec.validate()
    out: List[FuzzScenario] = []

    if spec.include_pure:
        for fname in spec.families:
            wl = family_workload(
                fname, days=spec.days, scale=spec.scale,
                seed=derive_seed(spec.seed, "pure", fname))
            out.append(FuzzScenario(
                name=f"pure/{fname}", family=fname, workload=wl,
                scenario=_storm_scenario(wl.family, wl),
                axes={"pure": True}))

    for i in range(spec.n_composed):
        rng = np.random.default_rng(
            derive_seed(spec.seed, "compose", i))
        fname = spec.families[int(rng.integers(0, len(spec.families)))]
        wl = family_workload(
            fname, days=spec.days, scale=spec.scale,
            seed=derive_seed(spec.seed, "compose", i, fname))
        duration_h = spec.days * 24.0
        regions = tuple(wl.regions)
        models = tuple(wl.models)

        # axis activation: independent coin per axis, then the axes
        # with the smallest draws are forced on until >= 2 are active
        # (a composed scenario with < 2 axes is just a noisy pure run)
        names = ("outage", "popshift", "burst", "preempt")
        probs = (spec.p_outage, spec.p_popshift, spec.p_burst,
                 spec.p_preempt)
        u = rng.uniform(0.0, 1.0, len(names))
        active = {n: bool(u[j] < probs[j]) for j, n in enumerate(names)}
        for j in np.argsort(u):
            if sum(active.values()) >= 2:
                break
            active[names[int(j)]] = True

        axes: Dict = {}
        extra_wins: List[Tuple[str, float, float]] = []
        if active["outage"]:
            rg = regions[int(rng.integers(0, len(regions)))]
            start_h = float(rng.uniform(0.15, 0.6) * duration_h)
            dur_h = float(rng.uniform(1.0, 3.0))
            end_h = min(start_h + dur_h, duration_h)
            extra_wins.append((rg, start_h * 3600.0, end_h * 3600.0))
            axes["outage"] = {"region": rg,
                              "start_hour": round(start_h, 3),
                              "end_hour": round(end_h, 3)}
        if active["popshift"]:
            model = models[int(rng.integers(0, len(models)))]
            start_h = float(rng.uniform(0.0, 0.7) * duration_h)
            end_h = min(start_h + float(rng.uniform(2.0, 6.0)),
                        duration_h)
            mult = float(rng.choice(np.asarray([0.0, 3.0, 8.0])))
            wl = dataclasses.replace(wl, pop_shifts=wl.pop_shifts + (
                PopularityShift(model, start_h, end_h, mult),))
            axes["popshift"] = {"model": model, "mult": mult,
                                "start_hour": round(start_h, 3),
                                "end_hour": round(end_h, 3)}
        if active["burst"]:
            n_b = int(rng.integers(1, 3))
            hours = tuple(sorted(round(float(h), 3) for h in rng.uniform(
                0.0, max(duration_h - 1.0, 0.5), n_b)))
            mult = float(rng.uniform(4.0, 10.0))
            wl = dataclasses.replace(wl, burst_mult=round(mult, 3),
                                     burst_hours=hours)
            axes["burst"] = {"mult": round(mult, 3), "hours": list(hours)}
        if active["preempt"]:
            storm = PreemptionStorm(
                events=int(rng.integers(4, 11)),
                mean_duration_min=float(rng.uniform(8.0, 20.0)),
                salt=i + 1)
            extra_wins.extend(storm.to_windows(
                spec.days, regions, wl.seed))
            axes["preempt"] = {"events": storm.events,
                               "mean_duration_min": round(
                                   storm.mean_duration_min, 3)}
        if spec.scale_jitter > 0:
            factor = float(np.exp(rng.uniform(-spec.scale_jitter,
                                              spec.scale_jitter)))
            wl = dataclasses.replace(
                wl, scale=round(spec.scale * factor, 8))
            axes["scale"] = {"factor": round(factor, 4)}

        tags = "+".join(sorted(k for k in axes if k != "scale"))
        out.append(FuzzScenario(
            name=f"fuzz{i:02d}/{fname}+{tags}", family=fname,
            workload=wl,
            scenario=_storm_scenario(wl.family, wl,
                                     tuple(extra_wins)),
            axes=axes))
    return tuple(out)


def fuzz_experiment(spec: FuzzSpec,
                    scenarios: Optional[Tuple[FuzzScenario, ...]] = None
                    ) -> ExperimentSpec:
    """Lift the scenario grid into an explicit-variant ExperimentSpec
    on the vector engine: every stack of a scenario shares the
    identical trace (same WorkloadSpec ⇒ memoized generation) and the
    scenario's capacity windows."""
    spec.validate()
    if scenarios is None:
        scenarios = fuzz_scenarios(spec)
    variants = []
    for sc in scenarios:
        for stack in spec.stacks:
            variants.append(Variant(
                name=f"{stack}/{sc.name}",
                stack=fuzz_stack(stack, sc.workload.models,
                                 sc.workload.regions, sc.scenario),
                workload=sc.workload, strategy=stack,
                workload_name=sc.name))
    return ExperimentSpec(name=f"fuzz-{spec.seed}",
                          variants=tuple(variants), engine="vector")


# ------------------------------------------------------------------- scoring
def _dominates(a: Dict, b: Dict) -> bool:
    """True iff stack ``a`` dominates ``b`` on the (dollars, worst-tier
    IW SLA) frontier: no worse on both, strictly better on one."""
    le = a["gpu_dollars"] <= b["gpu_dollars"]
    ge = a["iw_sla_min"] >= b["iw_sla_min"]
    strict = (a["gpu_dollars"] < b["gpu_dollars"]
              or a["iw_sla_min"] > b["iw_sla_min"])
    return le and ge and strict


def score_results(spec: FuzzSpec, scenarios: Tuple[FuzzScenario, ...],
                  results: ResultSet,
                  baseline: str = BASELINE_STACK) -> Dict:
    """Fold a fuzz ResultSet into the BENCH_fuzz scenario table:
    per-scenario per-stack cost/SLA metrics, the dominated-stack list,
    and deltas vs the ``baseline`` stack (negative ``gpu_dollars_pct``
    = cheaper than baseline)."""
    by = {(r.workload, r.strategy): r for r in results}
    table: Dict[str, Dict] = {}
    dominated_counts = {s: 0 for s in spec.stacks}
    for sc in scenarios:
        stacks: Dict[str, Dict] = {}
        for stack in spec.stacks:
            r = by.get((sc.name, stack))
            if r is None:
                continue
            iw_sla = {t: round(r.sla_attainment(t), 6)
                      for t in (TIER_IWF, TIER_IWN)}
            stacks[stack] = {
                "gpu_dollars": round(r.total_gpu_dollars, 2),
                "iw_sla": iw_sla,
                "iw_sla_min": round(min(iw_sla.values()), 6),
                "niw_sla": round(r.sla_attainment(TIER_NIW), 6),
                "completion": round(r.completion, 6),
                "drop_frac": round(
                    r.dropped_total / max(r.n_requests, 1), 6),
                "park_frac": round(
                    int(r.report.get("parked", 0))
                    / max(r.n_requests, 1), 6),
                "n_requests": r.n_requests,
                "engine": r.engine,
                "wall_s": round(r.wall_s, 3),
            }
        dominated = sorted(
            a for a in stacks
            if any(_dominates(stacks[b], stacks[a])
                   for b in stacks if b != a))
        for s in dominated:
            dominated_counts[s] += 1
        deltas = {}
        base = stacks.get(baseline)
        if base:
            for stack in sorted(stacks):
                if stack == baseline:
                    continue
                m = stacks[stack]
                deltas[stack] = {
                    "gpu_dollars_pct": round(
                        100.0 * (m["gpu_dollars"] / base["gpu_dollars"]
                                 - 1.0) if base["gpu_dollars"] else 0.0,
                        3),
                    "iw_sla_min_delta": round(
                        m["iw_sla_min"] - base["iw_sla_min"], 6),
                }
        table[sc.name] = {"family": sc.family, "axes": dict(sc.axes),
                          "stacks": stacks, "dominated": dominated,
                          "deltas_vs_baseline": deltas}
    return {
        "baseline": baseline,
        "scenarios": table,
        "summary": {
            "n_scenarios": len(table),
            "n_families": len({sc.family for sc in scenarios}),
            "dominated_counts": dominated_counts,
        },
    }
