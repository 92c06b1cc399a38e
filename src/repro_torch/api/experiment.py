"""Declarative experiment layer: spec'd sweeps, a parallel runner, and
stable result artifacts.

The paper's headline numbers come from *sweeps* — many strategies over
many workloads, scenarios and seeds — and every variant must run through
the same construction path (``StackSpec`` → ``build_stack``) for the
comparison to stay honest.  This module is the layer above that path:

- ``ExperimentSpec`` names the sweep: a ``strategies`` axis (label →
  ``StackSpec``), a ``workloads`` axis (label → ``WorkloadSpec``), an
  optional ``seeds`` axis, or an explicit ``variants`` list when the
  axes are coupled (e.g. a scenario that shapes both the workload and
  the stack).  It round-trips through ``to_dict``/``from_dict`` (JSON-
  able, unknown keys rejected) and ``validate``s every nested spec —
  the same contract as ``StackSpec``.
- ``run_experiment`` executes the expanded variants on a process pool.
  Each unique ``WorkloadSpec`` is generated exactly once (columnar
  ``Trace``); every run — including back-to-back serial runs — receives
  *fresh* ``Request`` objects materialized from the immutable columns,
  so the shared-mutable-trace hazard of handing one request list to
  several simulations is structurally impossible.
- ``RunResult``/``ResultSet`` are the stable artifact: per-variant spec
  hash, wall time, request count and the ``report_to_dict`` view of the
  ``Report``, JSON on disk, with baseline-comparison helpers for
  gpu-dollar / instance-hour / SLA-attainment deltas.

Example::

    exp = ExperimentSpec(
        name="fig11",
        strategies={s: stack_spec(bench, s) for s in ("reactive", "lt-ua")},
        workloads={"day": WorkloadSpec(days=1.0, scale=0.15)})
    results = run_experiment(exp, jobs=4, out="results/fig11.json")
    results.deltas(baseline="reactive")

Probes — named callables ``(requests, report) -> JSON-able`` — run in
the worker right after the simulation, for request-level statistics the
aggregate ``Report`` does not carry (per-model percentiles, burst-window
latencies).  They are runtime arguments, not part of the declarative
spec; their outputs land in ``RunResult.extras`` and the artifact.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.api.spec import StackSpec, strict_from_dict
from repro_torch.sim.workload import Trace, WorkloadSpec, generate_trace

SCHEMA = "repro_torch.experiment/v1"

Probe = Callable[[Sequence, object], object]


def derive_seed(*parts) -> int:
    """Deterministic 32-bit seed from any hashable coordinates (base
    seed, axis labels, seed index).  Stable across processes and runs —
    unlike ``hash()`` — so sweeps are reproducible from the spec alone."""
    h = hashlib.sha256(repr(parts).encode("utf-8")).digest()
    return int.from_bytes(h[:4], "little")


def spec_hash(d: Mapping) -> str:
    """Short content hash of a canonical-JSON spec dict."""
    blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _workload_key(wl: WorkloadSpec) -> str:
    return json.dumps(wl.to_dict(), sort_keys=True)


# --------------------------------------------------------------------- specs
@dataclasses.dataclass
class Variant:
    """One fully-resolved run: a stack over a workload, with the axis
    labels (``strategy``, ``workload_name``) the result layer groups and
    baselines by."""

    name: str
    stack: StackSpec
    workload: WorkloadSpec
    strategy: str = ""
    workload_name: str = ""

    def __post_init__(self):
        if isinstance(self.stack, Mapping):
            self.stack = StackSpec.from_dict(self.stack)
        if isinstance(self.workload, Mapping):
            self.workload = WorkloadSpec.from_dict(self.workload)
        if not self.strategy:
            self.strategy = self.name
        if not self.workload_name:
            self.workload_name = "default"

    def validate(self) -> "Variant":
        if not self.name:
            raise ValueError("Variant.name must be non-empty")
        self.stack.validate()
        self.workload.validate()
        return self

    def to_dict(self) -> Dict:
        return {"name": self.name, "stack": self.stack.to_dict(),
                "workload": self.workload.to_dict(),
                "strategy": self.strategy,
                "workload_name": self.workload_name}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Variant":
        return strict_from_dict(cls, d)


@dataclasses.dataclass
class ExperimentSpec:
    """A named sweep.  Either the cartesian axes (``strategies`` ×
    ``workloads`` × ``seeds``) or an explicit ``variants`` list — the
    latter for sweeps whose axes are coupled, e.g. a stress scenario
    that shapes both the workload (popularity shifts) and the stack
    (outage windows).

    ``seeds`` semantics: empty (default) runs each workload at its own
    ``WorkloadSpec.seed``; non-empty replaces it with
    ``derive_seed(workload.seed, workload_label, s)`` per entry ``s`` —
    deterministic, distinct per workload, and shared by every strategy
    of the variant so strategies always compare on the identical trace.

    ``profiles`` maps model → ``repro_torch.sim.perfmodel.PROFILES`` name to
    re-hardware the whole sweep (e.g. ``{"llama2-70b":
    "llama2-70b@a100"}``).
    """

    name: str
    strategies: Dict[str, StackSpec] = dataclasses.field(
        default_factory=dict)
    workloads: Dict[str, WorkloadSpec] = dataclasses.field(
        default_factory=dict)
    seeds: Tuple[int, ...] = ()
    variants: Tuple[Variant, ...] = ()
    profiles: Dict[str, str] = dataclasses.field(default_factory=dict)
    # simulation engine: "event" (discrete-event loop) or "vector"
    # (repro_torch.sim.vector — replicas sharing a group key run batched
    # under vmap; unsupported components fall back to the event loop)
    engine: str = "event"

    def __post_init__(self):
        self.strategies = {
            k: (v if isinstance(v, StackSpec) else StackSpec.from_dict(v))
            for k, v in dict(self.strategies).items()}
        self.workloads = {
            k: (v if isinstance(v, WorkloadSpec)
                else WorkloadSpec.from_dict(v))
            for k, v in dict(self.workloads).items()}
        self.seeds = tuple(self.seeds)
        self.variants = tuple(
            v if isinstance(v, Variant) else Variant.from_dict(v)
            for v in self.variants)
        self.profiles = dict(self.profiles)

    # ------------------------------------------------------------- expansion
    def expand(self) -> Tuple[Variant, ...]:
        """The resolved variant list: explicit ``variants`` verbatim, or
        the cartesian product of the axes."""
        if self.variants:
            return self.variants
        out: List[Variant] = []
        for wname, wl in self.workloads.items():
            for s in (self.seeds or (None,)):
                if s is None:
                    wls, tag = wl, ""
                else:
                    wls = dataclasses.replace(
                        wl, seed=derive_seed(wl.seed, wname, s))
                    tag = f"/s{s}"
                for sname, stack in self.strategies.items():
                    out.append(Variant(
                        name=f"{sname}/{wname}{tag}", stack=stack,
                        workload=wls, strategy=sname, workload_name=wname))
        return tuple(out)

    # -------------------------------------------------------------- validate
    def validate(self) -> "ExperimentSpec":
        if not self.name:
            raise ValueError("ExperimentSpec.name must be non-empty")
        if not self.variants and not self.strategies:
            raise ValueError(
                "ExperimentSpec needs a strategies axis or an explicit "
                "variants list")
        if self.variants and (self.strategies or self.workloads
                              or self.seeds):
            # expand() would silently drop the axes; make the
            # either-or contract loud instead
            raise ValueError(
                "ExperimentSpec takes either the cartesian axes "
                "(strategies/workloads/seeds) or an explicit variants "
                "list, not both")
        if self.strategies and not self.variants and not self.workloads:
            raise ValueError(
                "ExperimentSpec.workloads must be non-empty when "
                "expanding the cartesian axes")
        for s in self.seeds:
            if not isinstance(s, int):
                raise ValueError(
                    f"ExperimentSpec.seeds must be ints (got {s!r})")
        if self.engine not in ("event", "vector"):
            raise ValueError(
                f"ExperimentSpec.engine must be 'event' or 'vector' "
                f"(got {self.engine!r})")
        expanded = self.expand()
        seen = set()
        for v in expanded:
            v.validate()
            if v.name in seen:
                raise ValueError(
                    f"duplicate variant name {v.name!r}")
            seen.add(v.name)
        if self.profiles:
            from repro_torch.sim.perfmodel import PROFILES
            for model, prof in self.profiles.items():
                if prof not in PROFILES:
                    raise KeyError(
                        f"ExperimentSpec.profiles[{model!r}]: no perf "
                        f"profile named {prof!r}")
        return self

    # ------------------------------------------------------------- dict I/O
    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "strategies": {k: v.to_dict()
                           for k, v in self.strategies.items()},
            "workloads": {k: v.to_dict()
                          for k, v in self.workloads.items()},
            "seeds": list(self.seeds),
            "variants": [v.to_dict() for v in self.variants],
            "profiles": dict(self.profiles),
            "engine": self.engine,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExperimentSpec":
        return strict_from_dict(cls, d)


# ------------------------------------------------------------------- results
@dataclasses.dataclass
class RunResult:
    """One variant's outcome in artifact form: identity (labels + spec
    hash), run metadata, the stable ``report_to_dict`` view of the
    ``Report``, and probe outputs.  Everything is JSON-able, and every
    helper reads the dict form — results loaded from disk behave
    exactly like freshly-run ones."""

    variant: str
    strategy: str
    workload: str
    seed: int
    spec_hash: str
    wall_s: float
    n_requests: int
    report: Dict
    extras: Dict = dataclasses.field(default_factory=dict)
    engine: str = "event"     # which simulation engine produced this

    # ------------------------------------------------------------ accessors
    @property
    def total_instance_hours(self) -> float:
        return float(sum(self.report["instance_hours"].values()))

    @property
    def total_wasted_hours(self) -> float:
        return float(sum(self.report["wasted_hours"].values()))

    @property
    def total_spot_hours(self) -> float:
        return float(sum(self.report["spot_hours"].values()))

    @property
    def total_gpu_dollars(self) -> float:
        return float(self.report["gpu_dollars_total"])

    @property
    def completed_total(self) -> int:
        return int(sum(self.report["completed"].values()))

    @property
    def dropped_total(self) -> int:
        return int(sum(self.report["dropped"].values()))

    @property
    def completion(self) -> float:
        """Completed fraction, derived from the Report (not from
        re-scanning a shared trace for non-NaN latencies)."""
        return self.completed_total / max(self.n_requests, 1)

    @property
    def sla_violations(self) -> Dict[str, float]:
        return self.report["sla_violations"]

    def sla_attainment(self, tier: str) -> float:
        return 1.0 - self.report["sla_violations"].get(tier, 0.0)

    def model_instance_hours(self, model: str) -> float:
        return float(sum(v for k, v in self.report["instance_hours"]
                         .items() if k.split("|")[0] == model))

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "RunResult":
        return strict_from_dict(cls, d)


@dataclasses.dataclass
class ResultSet:
    """All results of one experiment, in variant order, plus the spec
    that produced them.  ``save``/``load`` round-trip the whole artifact
    as JSON."""

    experiment: Dict
    results: Tuple[RunResult, ...]
    schema: str = SCHEMA

    def __post_init__(self):
        self.results = tuple(
            r if isinstance(r, RunResult) else RunResult.from_dict(r)
            for r in self.results)

    def __iter__(self):
        return iter(self.results)

    def __len__(self) -> int:
        return len(self.results)

    # ------------------------------------------------------------ selection
    def select(self, strategy: Optional[str] = None,
               workload: Optional[str] = None,
               seed: Optional[int] = None) -> List[RunResult]:
        return [r for r in self.results
                if (strategy is None or r.strategy == strategy)
                and (workload is None or r.workload == workload)
                and (seed is None or r.seed == seed)]

    def get(self, variant: Optional[str] = None, *,
            strategy: Optional[str] = None,
            workload: Optional[str] = None,
            seed: Optional[int] = None) -> RunResult:
        if variant is not None:
            hits = [r for r in self.results if r.variant == variant]
        else:
            hits = self.select(strategy, workload, seed)
        if len(hits) != 1:
            raise KeyError(
                f"ResultSet.get matched {len(hits)} results (variant="
                f"{variant!r} strategy={strategy!r} workload={workload!r} "
                f"seed={seed!r}); have: "
                f"{', '.join(r.variant for r in self.results)}")
        return hits[0]

    # ----------------------------------------------------------- comparison
    def deltas(self, baseline: str) -> Dict[str, Dict]:
        """Per-variant deltas against the ``baseline`` strategy run on
        the *same* (workload, seed): gpu-dollars, instance-hours and
        per-tier SLA attainment.  Positive dollar/hour deltas and pcts
        mean the variant is cheaper than the baseline."""
        base = {(r.workload, r.seed): r for r in self.results
                if r.strategy == baseline}
        if not base:
            raise KeyError(
                f"no results for baseline strategy {baseline!r}")
        out: Dict[str, Dict] = {}
        for r in self.results:
            if r.strategy == baseline:
                continue
            b = base.get((r.workload, r.seed))
            if b is None:
                continue

            def _d(mine: float, theirs: float) -> Dict[str, float]:
                return {"base": theirs, "ours": mine,
                        "delta": theirs - mine,
                        "pct": (100.0 * (1.0 - mine / theirs)
                                if theirs else 0.0)}

            tiers = set(r.sla_violations) | set(b.sla_violations)
            out[r.variant] = {
                "vs": b.variant,
                "gpu_dollars": _d(r.total_gpu_dollars,
                                  b.total_gpu_dollars),
                "instance_hours": _d(r.total_instance_hours,
                                     b.total_instance_hours),
                "sla_attainment": {
                    t: {"base": b.sla_attainment(t),
                        "ours": r.sla_attainment(t),
                        "delta": r.sla_attainment(t) - b.sla_attainment(t)}
                    for t in sorted(tiers)},
            }
        return out

    # ------------------------------------------------------------- artifact
    def to_dict(self) -> Dict:
        return {"schema": self.schema, "experiment": self.experiment,
                "results": [r.to_dict() for r in self.results]}

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def from_dict(cls, d: Mapping) -> "ResultSet":
        return strict_from_dict(cls, d)

    @classmethod
    def load(cls, path: str) -> "ResultSet":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# -------------------------------------------------------------------- runner
_TRACE_COLS = ("rid", "model_idx", "region_idx", "tier_idx", "arrival",
               "prompt_tokens", "output_tokens", "ttft_deadline",
               "deadline")

# per-worker-process cache of traces loaded from the runner's spill
# files: each worker deserializes a given workload's trace at most once,
# however many of its variants land on that worker
_WORKER_TRACES: Dict[str, Trace] = {}


def _dump_trace(trace: Trace, path: str) -> str:
    """Spill a columnar trace to ``.npz`` so the parallel runner ships
    each unique workload to the workers once (via the filesystem)
    instead of re-pickling multi-GB columns per submitted variant."""
    meta = json.dumps({"models": list(trace.models),
                       "regions": list(trace.regions),
                       "tiers": list(trace.tiers)})
    cols = {c: getattr(trace, c) for c in _TRACE_COLS}
    if trace.session is not None:     # optional KV-affinity column
        cols["session"] = trace.session
    with open(path, "wb") as f:
        np.savez(f, meta=np.array(meta), **cols)
    return path


def _load_trace(path: str) -> Trace:
    tr = _WORKER_TRACES.get(path)
    if tr is None:
        with np.load(path) as z:
            meta = json.loads(z["meta"].item())
            tr = Trace(models=tuple(meta["models"]),
                       regions=tuple(meta["regions"]),
                       tiers=tuple(meta["tiers"]),
                       session=(z["session"] if "session" in z.files
                                else None),
                       **{c: z[c] for c in _TRACE_COLS})
        _WORKER_TRACES[path] = tr
    return tr


def _resolve_profiles(profile_names: Optional[Mapping[str, str]]):
    if not profile_names:
        return None
    from repro_torch.sim.perfmodel import PROFILES
    return {model: PROFILES[prof]
            for model, prof in profile_names.items()}


def _run_variant(variant_dict: Dict, trace: Union[Trace, str],
                 profile_names: Optional[Dict[str, str]],
                 include_util_trace: bool,
                 probes: Optional[Dict[str, Probe]],
                 device: str) -> RunResult:
    """Execute one variant.  Top-level so process-pool workers (spawn
    start method) can unpickle it; receives the memoized columnar trace
    (in-process, or a spill-file path in workers) and materializes its
    *own* Request objects, so no two runs ever share mutable request
    state.  ``device``: where the stack's forecast fits run (a worker
    process opens its own CUDA context)."""
    from repro_torch.api.stack import build_stack
    from repro_torch.sim.metrics import report_to_dict

    variant = Variant.from_dict(variant_dict)
    if isinstance(trace, str):
        trace = _load_trace(trace)
    requests = trace.to_requests()
    stack = build_stack(variant.stack,
                        profiles=_resolve_profiles(profile_names),
                        device=device)
    t0 = time.perf_counter()
    report = stack.simulate(requests, name=variant.name)
    wall = time.perf_counter() - t0
    extras = {name: fn(requests, report)
              for name, fn in (probes or {}).items()}
    return RunResult(
        variant=variant.name, strategy=variant.strategy,
        workload=variant.workload_name, seed=variant.workload.seed,
        spec_hash=spec_hash(variant.to_dict()), wall_s=wall,
        n_requests=len(requests),
        report=report_to_dict(report,
                              include_util_trace=include_util_trace),
        extras=extras)


def _run_vector(variants, traces, profile_names,
                include_util_trace, probes, device) -> List[RunResult]:
    """Vector-engine sweep path: variants sharing a workload and a
    vector group key (same models/regions/pools/profiles/tick) run as
    ONE vmapped ``VectorBatch``; components without a vector lowering
    fall back to the event loop per variant.  Always in-process (the
    batch steps on ``device``), so ``jobs`` does not apply."""
    from repro_torch.api.stack import build_stack
    from repro_torch.sim.metrics import report_to_dict
    from repro_torch.sim.vector import VectorBatch, VectorUnsupported
    from repro_torch.sim.vector.params import extract, group_key

    prof = _resolve_profiles(profile_names)
    out: List[Optional[RunResult]] = [None] * len(variants)
    by_wl: Dict[str, List[int]] = {}
    for i, v in enumerate(variants):
        by_wl.setdefault(_workload_key(v.workload), []).append(i)

    def _result(i, report, wall, n, engine):
        v = variants[i]
        extras = {}
        if probes:
            reqs = traces[_workload_key(v.workload)].to_requests()
            extras = {name: fn(reqs, report)
                      for name, fn in probes.items()}
        return RunResult(
            variant=v.name, strategy=v.strategy,
            workload=v.workload_name, seed=v.workload.seed,
            spec_hash=spec_hash(v.to_dict()), wall_s=wall,
            n_requests=n, engine=engine,
            report=report_to_dict(report,
                                  include_util_trace=include_util_trace),
            extras=extras)

    for wkey, idxs in by_wl.items():
        trace = traces[wkey]
        groups: Dict[Tuple, List[Tuple[int, object]]] = {}
        fallback: List[int] = []
        stacks = {}
        for i in idxs:
            v = variants[i]
            stack = build_stack(v.stack, profiles=prof, device=device)
            stacks[i] = stack
            cfg = stack.sim_config()
            models = list(stack.spec.models)
            regions = list(stack.spec.regions)
            try:
                rp = extract(cfg, models, regions, stack.profiles,
                             v.name)
                if cfg.siloed and rp.mode != 0:
                    raise VectorUnsupported("siloed non-reactive")
                gk = group_key(rp, tuple(models), tuple(regions),
                               stack.profiles)
            except VectorUnsupported:
                fallback.append(i)
                continue
            groups.setdefault(gk, []).append((i, cfg))
        for members in groups.values():
            i0 = members[0][0]
            st0 = stacks[i0]
            t0 = time.perf_counter()
            try:
                batch = VectorBatch(
                    trace, [c for _, c in members],
                    names=[variants[i].name for i, _ in members],
                    models=list(st0.spec.models),
                    regions=list(st0.spec.regions),
                    profiles=st0.profiles, device=device)
                reports = batch.run()
            except VectorUnsupported:
                fallback.extend(i for i, _ in members)
                continue
            wall = (time.perf_counter() - t0) / len(members)
            # batch-level control-plane stats (hourly boundaries are
            # shared work): attached to every member with the batch id,
            # so aggregators can dedupe by it
            ctl = dict(getattr(batch, "control_stats", None) or {})
            if ctl:
                ctl["batch"] = variants[i0].name
                ctl["replicas"] = len(members)
            for (i, _), rep in zip(members, reports):
                out[i] = _result(i, rep, wall, len(trace), "vector")
                if ctl:
                    out[i].extras["control"] = dict(ctl)
        for i in fallback:
            v = variants[i]
            reqs = trace.to_requests()
            t0 = time.perf_counter()
            rep = stacks[i].simulate(reqs, name=v.name)
            out[i] = _result(i, rep, time.perf_counter() - t0,
                             len(reqs), "event")
    return out


def run_experiment(spec: ExperimentSpec, jobs: Optional[int] = None,
                   out: Optional[str] = None,
                   probes: Optional[Dict[str, Probe]] = None,
                   include_util_trace: bool = False,
                   device: DeviceLike = None) -> ResultSet:
    """Validate, expand, generate each unique workload trace once, and
    run every variant — in-process when ``jobs`` resolves to 1, else on
    a spawn-based process pool (safe to call after CUDA has run in the
    parent, unlike fork).

    ``jobs=None`` defaults to the CPU count, capped by the variant
    count.  In the parallel path each unique trace is spilled to a temp
    ``.npz`` once and workers load-and-cache it at most once per
    process — the columns are never re-pickled per variant.  Results
    come back in variant order regardless of completion order, so
    parallel runs are output-identical to serial ones.
    ``out`` additionally writes the JSON artifact.  ``probes`` must be
    module-level callables when running with ``jobs > 1`` (they cross
    the process boundary by reference).  ``device``: where vector
    batches step and forecast fits run, CUDA unless ``"cpu"``; raises
    when CUDA is asked for (explicitly or by default) and absent.
    """
    spec.validate()
    variants = spec.expand()
    device = str(resolve_device(device))

    # per-unique-WorkloadSpec memoization: generate once, share the
    # immutable columns; every run materializes fresh Request objects
    traces: Dict[str, Trace] = {}
    for v in variants:
        key = _workload_key(v.workload)
        if key not in traces:
            traces[key] = generate_trace(v.workload)

    if jobs is None:
        jobs = os.cpu_count() or 1
    jobs = max(1, min(int(jobs), len(variants)))

    if spec.engine == "vector":
        results = _run_vector(variants, traces, spec.profiles or None,
                              include_util_trace, probes, device)
    elif jobs == 1:
        results = [_run_variant(v.to_dict(), traces[_workload_key(
            v.workload)], spec.profiles or None, include_util_trace,
            probes, device) for v in variants]
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        ctx = multiprocessing.get_context("spawn")
        tmpdir = tempfile.mkdtemp(prefix="repro-experiment-")
        try:
            paths = {key: _dump_trace(tr, os.path.join(
                tmpdir, f"trace{i}.npz"))
                for i, (key, tr) in enumerate(traces.items())}
            with ProcessPoolExecutor(max_workers=jobs,
                                     mp_context=ctx) as pool:
                futs = [pool.submit(
                    _run_variant, v.to_dict(),
                    paths[_workload_key(v.workload)],
                    spec.profiles or None, include_util_trace, probes,
                    device) for v in variants]
                results = [f.result() for f in futs]
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)

    rs = ResultSet(experiment=spec.to_dict(), results=tuple(results))
    if out:
        rs.save(out)
    return rs
