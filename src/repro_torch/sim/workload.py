"""Synthetic production-like workload traces + replay.

The O365 traces are proprietary ("will be released upon acceptance"), so
we generate traces matched to every statistic the paper publishes (§3):

- three tiers; IW-F largest, IW (F+N) = 72 % of requests, IW:NIW ≈ 3:1;
- IW-F/IW-N strongly diurnal with weekend quiescing; NIW flat/aperiodic;
- per-region model popularity skew (Model A: East ≈ 4× West; Model B
  peaks in Central for IW-F and West for IW-N);
- token counts: log-normal prompt (majority > 1k) and output (< 1k)
  per Fig. 10; NIW token counts comparable to IW (paper §6.2 assumption);
- peak-day volume anchor: 1.4 M IW + 0.2 M NIW per region-day at scale=1
  (West US, Tuesday Nov 2024);
- optional synthetic 8× bursts (§7.2.7).

Generation is fully vectorized (see docs/PERF.md): all per-minute
Poisson counts, arrival offsets, model indices and token lengths for a
(region, tier) are drawn as whole-trace numpy arrays, and the result is
a columnar ``Trace`` (struct-of-arrays).  ``Trace.to_requests()``
bridges to the simulator's ``Request`` objects; benchmarks that only
need aggregates (``tps_series``) can stay columnar and never pay the
object-materialization cost — at 10M requests that is the difference
between milliseconds and tens of seconds.

Real traces drop in via ``replay_csv`` (plain or ``.gz``) with the same
Request schema.
"""
from __future__ import annotations

import csv
import dataclasses
import gzip
import math
from typing import (Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.sim.types import (NIW_DEADLINE, Request, TIER_IWF, TIER_IWN,
                             TIER_NIW, TTFT_SLA)

REGIONS = ("eastus", "westus", "centralus")
PAPER_MODELS = ("bloom-176b", "llama2-70b", "llama3.1-8b", "llama3.2-3b")

# model-popularity weight per region [model, region] — encodes the §3 skew
_POP_IWF = {
    "eastus":    (0.15, 0.25, 0.35, 0.25),
    "westus":    (0.08, 0.22, 0.40, 0.30),
    "centralus": (0.12, 0.35, 0.30, 0.23),
}
_POP_NIW = {
    "eastus":    (0.20, 0.30, 0.30, 0.20),
    "westus":    (0.10, 0.20, 0.40, 0.30),
    "centralus": (0.18, 0.32, 0.30, 0.20),
}
# regional volume multiplier (East > Central > West for IW)
_REGION_AMP = {"eastus": 1.35, "westus": 0.75, "centralus": 1.0}


@dataclasses.dataclass(frozen=True)
class PopularityShift:
    """Hour-indexed model-popularity shift: within [start_hour,
    end_hour) the model's popularity weight is multiplied by ``mult``
    (0 ⇒ demand vanishes, ≫1 ⇒ it spikes) in ``regions`` (None ⇒ all).
    The scenario knob placement planning exists for: demand moving
    between models/regions faster than static placement can follow."""

    model: str
    start_hour: float
    end_hour: float
    mult: float
    regions: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.regions is not None:
            object.__setattr__(self, "regions", tuple(self.regions))
        if self.mult < 0:
            raise ValueError(
                f"PopularityShift[{self.model!r}]: mult must be >= 0 "
                f"(got {self.mult})")
        if self.end_hour <= self.start_hour:
            raise ValueError(
                f"PopularityShift[{self.model!r}]: end_hour "
                f"{self.end_hour} must be past start_hour "
                f"{self.start_hour}")

    def to_dict(self) -> Dict:
        return {"model": self.model, "start_hour": self.start_hour,
                "end_hour": self.end_hour, "mult": self.mult,
                "regions": (None if self.regions is None
                            else list(self.regions))}


@dataclasses.dataclass
class WorkloadSpec:
    days: float = 1.0
    scale: float = 0.1                   # traffic thinning factor
    models: Sequence[str] = PAPER_MODELS
    regions: Sequence[str] = REGIONS
    start_dow: int = 1                   # 0=Mon; Nov-trace peak day = Tue
    seed: int = 0
    iw_per_region_day: float = 1.4e6     # paper anchor (scale=1)
    niw_per_region_day: float = 0.2e6
    iwf_frac_of_iw: float = 0.65         # IW-F largest tier (§3)
    burst_mult: float = 0.0              # e.g. 8.0 for §7.2.7 bursts
    burst_hours: Tuple[float, ...] = ()
    prompt_lognorm: Tuple[float, float] = (7.2, 1.0)   # median ~1.3k
    output_lognorm: Tuple[float, float] = (5.2, 0.9)   # median ~180
    pop_shifts: Tuple[PopularityShift, ...] = ()       # scenario layer
    # structured workload family (repro_torch.workloads.WorkloadFamily): when
    # set, generation dispatches to the family compiler — multi-turn
    # sessions, heavy-tailed lengths, floods, flash crowds, weekly
    # seasonality — and the family's own rate/mix/length calibration
    # replaces this spec's iw/niw/lognorm knobs.  days / scale / seed /
    # models / regions / start_dow / pop_shifts / burst_* still apply,
    # so the scenario fuzzer can compose its axes on any family.
    family: Optional[object] = None

    def __post_init__(self):
        # normalize sequence fields to tuples so specs compare equal
        # across dict round-trips (JSON lists vs constructor tuples) and
        # canonicalize identically for trace memoization keys
        self.models = tuple(self.models)
        self.regions = tuple(self.regions)
        self.burst_hours = tuple(self.burst_hours)
        self.prompt_lognorm = tuple(self.prompt_lognorm)
        self.output_lognorm = tuple(self.output_lognorm)
        self.pop_shifts = tuple(
            s if isinstance(s, PopularityShift) else PopularityShift(**s)
            for s in self.pop_shifts)
        if self.family is not None and not hasattr(self.family, "compile"):
            # dict form (JSON round-trip): coerce through the library.
            # Lazy import — the workloads package imports this module.
            from repro_torch.workloads.families import WorkloadFamily
            self.family = WorkloadFamily.from_dict(self.family)

    # -------------------------------------------------------------- validate
    def validate(self) -> "WorkloadSpec":
        """Reject degenerate traces loudly: scenario knobs pointing
        outside the trace span used to *silently* generate a trace in
        which the scenario never happens."""
        if self.days <= 0:
            raise ValueError(f"WorkloadSpec.days must be positive "
                             f"(got {self.days})")
        if self.scale <= 0:
            raise ValueError(f"WorkloadSpec.scale must be positive "
                             f"(got {self.scale})")
        duration_h = self.days * 24.0
        if self.burst_mult < 0:
            raise ValueError(
                f"WorkloadSpec.burst_mult must be >= 0 (got "
                f"{self.burst_mult}); to silence a burst, drop its "
                f"burst_hours instead")
        for bh in self.burst_hours:
            if not 0.0 <= bh < duration_h:
                raise ValueError(
                    f"WorkloadSpec.burst_hours entry {bh} is outside the "
                    f"trace ([0, {duration_h}) hours for days="
                    f"{self.days}) — the burst would never fire")
        for s in self.pop_shifts:
            # end_hour past the trace end is the "until the end" idiom
            # and clips harmlessly; a start_hour outside the trace means
            # the shift never applies at all — reject that loudly.
            if s.start_hour < 0 or s.start_hour >= duration_h:
                raise ValueError(
                    f"pop_shifts[{s.model!r}]: start_hour {s.start_hour} "
                    f"is outside the trace ([0, {duration_h}) hours for "
                    f"days={self.days}) — the shift would never apply")
        if self.family is not None:
            self.family.validate()
        return self

    # ------------------------------------------------------------- dict I/O
    def to_dict(self) -> Dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "pop_shifts":
                v = [s.to_dict() for s in v]
            elif f.name == "family":
                v = None if v is None else v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d) -> "WorkloadSpec":
        # same strict contract as repro_torch.api.spec.strict_from_dict, kept
        # inline: the sim layer does not import the api layer
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise KeyError(
                f"unknown WorkloadSpec fields: {sorted(unknown)}")
        return cls(**dict(d))


def _diurnal_vec(hour_of_week: np.ndarray) -> np.ndarray:
    """Diurnal + weekday/weekend shape, peaks mid-day, quiesces weekends."""
    hour_of_week = np.asarray(hour_of_week, dtype=np.float64)
    dow = (hour_of_week // 24).astype(np.int64) % 7
    h = hour_of_week % 24
    base = 0.25 + 0.75 * np.maximum(
        0.0, np.sin(np.pi * (h - 7.0) / 14.0)) ** 1.5
    return base * np.where(dow >= 5, 0.35, 1.0)


def _diurnal(hour_of_week: float) -> float:
    return float(_diurnal_vec(np.asarray([hour_of_week]))[0])


@dataclasses.dataclass
class Trace:
    """Columnar (struct-of-arrays) trace: one aligned numpy column per
    ``Request`` field, with string columns interned through small index
    tables.  Rows are sorted by arrival; ``rid`` is the generation-order
    id (stable across the sort, like the object path always had)."""

    models: Tuple[str, ...]
    regions: Tuple[str, ...]
    tiers: Tuple[str, ...]
    rid: np.ndarray            # int64
    model_idx: np.ndarray      # int16 index into models
    region_idx: np.ndarray     # int16 index into regions
    tier_idx: np.ndarray       # int16 index into tiers
    arrival: np.ndarray        # float64 seconds
    prompt_tokens: np.ndarray  # int64
    output_tokens: np.ndarray  # int64
    ttft_deadline: np.ndarray  # float64 absolute
    deadline: np.ndarray       # float64 absolute
    # KV-reuse affinity: requests sharing a session id are turns of one
    # multi-turn conversation (repro_torch.workloads session families); -1 =
    # no session.  Optional — plain traces carry None and every
    # consumer that doesn't know about sessions keeps working.
    session: Optional[np.ndarray] = None    # int64, -1 = none

    def __len__(self) -> int:
        return int(self.arrival.shape[0])

    def sorted_by_arrival(self) -> "Trace":
        order = np.argsort(self.arrival, kind="stable")
        return dataclasses.replace(
            self, rid=self.rid[order], model_idx=self.model_idx[order],
            region_idx=self.region_idx[order], tier_idx=self.tier_idx[order],
            arrival=self.arrival[order],
            prompt_tokens=self.prompt_tokens[order],
            output_tokens=self.output_tokens[order],
            ttft_deadline=self.ttft_deadline[order],
            deadline=self.deadline[order],
            session=(None if self.session is None
                     else self.session[order]))

    # ---------------------------------------------------------------- bridge
    @classmethod
    def from_requests(cls, requests: Sequence[Request]) -> "Trace":
        """Columnarize ``Request`` objects (the inverse of
        ``to_requests``): the vector engine accepts either form but only
        ever touches the columns."""
        reqs = list(requests)
        models = tuple(sorted({r.model for r in reqs}))
        regions = tuple(sorted({r.region for r in reqs}))
        tiers = tuple(sorted({r.tier for r in reqs}))
        mi = {m: i for i, m in enumerate(models)}
        ri = {r: i for i, r in enumerate(regions)}
        ti = {t: i for i, t in enumerate(tiers)}
        return cls(
            models=models, regions=regions, tiers=tiers,
            rid=np.asarray([r.rid for r in reqs], np.int64),
            model_idx=np.asarray([mi[r.model] for r in reqs], np.int16),
            region_idx=np.asarray([ri[r.region] for r in reqs],
                                  np.int16),
            tier_idx=np.asarray([ti[r.tier] for r in reqs], np.int16),
            arrival=np.asarray([r.arrival for r in reqs], np.float64),
            prompt_tokens=np.asarray([r.prompt_tokens for r in reqs],
                                     np.int64),
            output_tokens=np.asarray([r.output_tokens for r in reqs],
                                     np.int64),
            ttft_deadline=np.asarray([r.ttft_deadline for r in reqs],
                                     np.float64),
            deadline=np.asarray([r.deadline for r in reqs], np.float64)
        ).sorted_by_arrival()

    def iter_requests(self, chunk: int = 65536) -> Iterator[Request]:
        """Stream ``Request`` objects in bounded chunks: peak extra
        memory is one chunk of per-field Python lists instead of the
        whole trace at once (~554 MB at scale 0.05 via the old
        all-at-once ``tolist`` path)."""
        models, regions, tiers = self.models, self.regions, self.tiers
        n = len(self)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            yield from (
                Request(i, models[mi], regions[ri], tiers[ti],
                        t, p, o, td, dl)
                for i, mi, ri, ti, t, p, o, td, dl in zip(
                    self.rid[lo:hi].tolist(),
                    self.model_idx[lo:hi].tolist(),
                    self.region_idx[lo:hi].tolist(),
                    self.tier_idx[lo:hi].tolist(),
                    self.arrival[lo:hi].tolist(),
                    self.prompt_tokens[lo:hi].tolist(),
                    self.output_tokens[lo:hi].tolist(),
                    self.ttft_deadline[lo:hi].tolist(),
                    self.deadline[lo:hi].tolist()))

    def to_requests(self) -> List[Request]:
        """Materialize ``Request`` objects (the event-loop simulator
        consumes objects).  Chunked through ``iter_requests`` so the
        transient per-field ``tolist`` copies stay bounded; the Request
        objects themselves are whatever the caller keeps."""
        return list(self.iter_requests())

    # ------------------------------------------------------------ aggregates
    def tps_series(self, window: float = 60.0,
                   duration: Optional[float] = None,
                   tiers: Optional[Tuple[str, ...]] = None
                   ) -> Dict[Tuple[str, str], np.ndarray]:
        """Vectorized input-TPS history per (model, region) — one
        ``bincount`` instead of a Python loop over requests."""
        if duration is None:
            duration = (float(self.arrival.max()) if len(self) else 0.0) \
                + window
        nb = int(duration / window) + 1
        sel = np.ones(len(self), dtype=bool)
        if tiers:
            keep = [i for i, t in enumerate(self.tiers) if t in tiers]
            sel = np.isin(self.tier_idx, keep)
        b = np.minimum((self.arrival / window).astype(np.int64), nb - 1)
        nr = len(self.regions)
        key = self.model_idx.astype(np.int64) * nr + self.region_idx
        flat = key[sel] * nb + b[sel]
        size = len(self.models) * nr * nb
        tot = np.bincount(flat, weights=self.prompt_tokens[sel] / window,
                          minlength=size).reshape(len(self.models), nr, nb)
        present = np.bincount(key[sel], minlength=len(self.models) * nr) > 0
        return {(self.models[i], self.regions[j]): tot[i, j]
                for i in range(len(self.models)) for j in range(nr)
                if present[i * nr + j]}


def generate_trace(spec: WorkloadSpec) -> Trace:
    """Vectorized trace generation: every (region, tier) draws its whole
    run of Poisson counts, offsets, model picks and token lengths as
    numpy arrays — no per-minute Python loop.

    A spec carrying a ``family`` (repro_torch.workloads) dispatches to the
    family compiler; the default path below is bit-identical to what it
    always generated."""
    spec.validate()
    if spec.family is not None:
        return spec.family.compile(spec)
    rng = np.random.default_rng(spec.seed)
    minutes = int(spec.days * 24 * 60)
    models = tuple(spec.models)
    regions = tuple(spec.regions)
    for s in spec.pop_shifts:
        # fail loud: a typo'd model/region would otherwise be silently
        # filtered out and the scenario would quietly not happen
        if s.model not in models:
            raise ValueError(
                f"pop_shifts: model {s.model!r} not in spec.models")
        for rg in s.regions or ():
            if rg not in regions:
                raise ValueError(
                    f"pop_shifts[{s.model!r}]: region {rg!r} not in "
                    f"spec.regions")
    tiers = (TIER_IWF, TIER_IWN, TIER_NIW)
    pm, ps = spec.prompt_lognorm
    om, osd = spec.output_lognorm

    # region-invariant day shape, hoisted out of the region loop
    mins = np.arange(minutes, dtype=np.float64)
    shape = _diurnal_vec(spec.start_dow * 24 + mins / 60.0)
    shape_mean = float(np.mean(_diurnal_vec(
        spec.start_dow * 24 + np.linspace(0, 24, 97)[:-1])))
    sh = shape / max(shape_mean, 1e-9)
    hour_idx = mins / 60.0
    burst = np.ones(minutes)
    for bh in spec.burst_hours:
        burst[(hour_idx >= bh) & (hour_idx < bh + 1.0)] = spec.burst_mult
    minute_starts = mins * 60.0

    def _fit(pop) -> np.ndarray:
        # extend/truncate to the model list (extra models get the mean
        # share), renormalized
        pop = list(pop)[:len(models)]
        while len(pop) < len(models):
            pop.append(sum(pop) / len(pop))
        z = sum(pop)
        return np.asarray([x / z for x in pop])

    cols: Dict[str, List[np.ndarray]] = {k: [] for k in (
        "model_idx", "region_idx", "tier_idx", "arrival",
        "prompt_tokens", "output_tokens", "ttft_deadline", "deadline")}

    for ri, region in enumerate(regions):
        amp = _REGION_AMP.get(region, 1.0)
        pop_iwf_raw = _POP_IWF.get(region,
                                   tuple([1 / len(models)] * len(models)))
        pop_iwf = _fit(pop_iwf_raw)
        pop_niw = _fit(_POP_NIW.get(region, pop_iwf_raw))
        iw_day = spec.iw_per_region_day * spec.scale * amp
        niw_day = spec.niw_per_region_day * spec.scale * amp
        lam_iw = iw_day / 1440.0 * sh * burst
        lam_niw = np.full(minutes, niw_day / 1440.0)  # flat

        for ti, (tier, lam, pop) in enumerate((
                (TIER_IWF, lam_iw * spec.iwf_frac_of_iw, pop_iwf),
                (TIER_IWN, lam_iw * (1 - spec.iwf_frac_of_iw), pop_iwf),
                (TIER_NIW, lam_niw, pop_niw))):
            counts = rng.poisson(lam)
            n = int(counts.sum())
            if n == 0:
                continue
            times = np.repeat(minute_starts, counts) + \
                rng.uniform(0, 60.0, n)
            shifts = [s for s in spec.pop_shifts
                      if s.model in models
                      and (s.regions is None or region in s.regions)]
            if shifts:
                # hour-indexed popularity: per-arrival weight rows with
                # shift multipliers applied, sampled by inverse CDF.
                # (The unshifted path keeps the original rng.choice so
                # default traces stay bit-identical.)
                w = np.tile(pop / pop.sum(), (n, 1))
                hours = times / 3600.0
                for s in shifts:
                    mask = (hours >= s.start_hour) & (hours < s.end_hour)
                    w[mask, models.index(s.model)] *= s.mult
                w /= w.sum(axis=1, keepdims=True)
                u = rng.uniform(0.0, 1.0, n)
                midx = np.minimum(
                    (u[:, None] > np.cumsum(w, axis=1)).sum(axis=1),
                    len(models) - 1)
            else:
                midx = rng.choice(len(models), size=n, p=pop / pop.sum())
            prompts = np.clip(rng.lognormal(pm, ps, n),
                              16, 32768).astype(np.int64)
            outs = np.clip(rng.lognormal(om, osd, n),
                           1, 4096).astype(np.int64)
            if tier == TIER_NIW:
                ttft_dl = times + NIW_DEADLINE
                dl = times + NIW_DEADLINE
            else:
                ttft_dl = times + TTFT_SLA[tier]
                dl = times + 30 * 60.0
            cols["model_idx"].append(midx.astype(np.int16))
            cols["region_idx"].append(np.full(n, ri, dtype=np.int16))
            cols["tier_idx"].append(np.full(n, ti, dtype=np.int16))
            cols["arrival"].append(times)
            cols["prompt_tokens"].append(prompts)
            cols["output_tokens"].append(outs)
            cols["ttft_deadline"].append(ttft_dl)
            cols["deadline"].append(dl)

    cat = {k: (np.concatenate(v) if v else np.zeros(
        0, dtype=np.int16 if k.endswith("idx") else
        (np.int64 if k.endswith("tokens") else np.float64)))
        for k, v in cols.items()}
    total = int(cat["arrival"].shape[0])
    trace = Trace(models=models, regions=regions, tiers=tiers,
                  rid=np.arange(total, dtype=np.int64), **cat)
    return trace.sorted_by_arrival()


def generate(spec: WorkloadSpec) -> List[Request]:
    return generate_trace(spec).to_requests()


def tps_series(reqs: Union["Trace", Sequence[Request]], window: float = 60.0,
               duration: Optional[float] = None,
               tiers: Optional[Tuple[str, ...]] = None
               ) -> Dict[Tuple[str, str], np.ndarray]:
    """Input-TPS history per (model, region) in `window`-second buckets.

    Accepts a columnar ``Trace`` (vectorized, no object overhead) or any
    sequence of ``Request``s.  Arrivals past a caller-supplied
    ``duration`` are clipped into the final bucket instead of raising."""
    if isinstance(reqs, Trace):
        return reqs.tps_series(window=window, duration=duration, tiers=tiers)
    if duration is None:
        duration = max(r.arrival for r in reqs) + window
    nb = int(duration / window) + 1
    out: Dict[Tuple[str, str], np.ndarray] = {}
    for r in reqs:
        if tiers and r.tier not in tiers:
            continue
        key = (r.model, r.region)
        if key not in out:
            out[key] = np.zeros(nb)
        out[key][min(int(r.arrival / window), nb - 1)] += \
            r.prompt_tokens / window
    return out


def replay_trace(path: str) -> Trace:
    """Load a real trace straight into the columnar ``Trace``: columns
    rid,model,region,tier,arrival,prompt_tokens,output_tokens
    [,ttft_deadline,deadline].  ``.gz`` paths are opened transparently.

    Rows accumulate into per-field Python lists and become numpy columns
    once — no intermediate ``Request`` objects, so replay ingest matches
    the generator's struct-of-arrays path and the vector engine can
    consume replayed traces without ever materializing objects."""
    cols: Dict[str, List] = {k: [] for k in (
        "rid", "model", "region", "tier", "arrival", "prompt", "output",
        "ttft", "deadline")}
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        for row in csv.DictReader(f):
            arrival = float(row["arrival"])
            tier = row["tier"]
            cols["rid"].append(int(row["rid"]))
            cols["model"].append(row["model"])
            cols["region"].append(row["region"])
            cols["tier"].append(tier)
            cols["arrival"].append(arrival)
            cols["prompt"].append(int(row["prompt_tokens"]))
            cols["output"].append(int(row["output_tokens"]))
            cols["ttft"].append(float(
                row.get("ttft_deadline") or
                (arrival + TTFT_SLA.get(tier, NIW_DEADLINE))))
            cols["deadline"].append(float(
                row.get("deadline") or (arrival + NIW_DEADLINE)))
    models = tuple(sorted(set(cols["model"])))
    regions = tuple(sorted(set(cols["region"])))
    tiers = tuple(sorted(set(cols["tier"])))
    mi = {m: i for i, m in enumerate(models)}
    ri = {r: i for i, r in enumerate(regions)}
    ti = {t: i for i, t in enumerate(tiers)}
    trace = Trace(
        models=models, regions=regions, tiers=tiers,
        rid=np.asarray(cols["rid"], np.int64),
        model_idx=np.asarray([mi[m] for m in cols["model"]], np.int16),
        region_idx=np.asarray([ri[r] for r in cols["region"]], np.int16),
        tier_idx=np.asarray([ti[t] for t in cols["tier"]], np.int16),
        arrival=np.asarray(cols["arrival"], np.float64),
        prompt_tokens=np.asarray(cols["prompt"], np.int64),
        output_tokens=np.asarray(cols["output"], np.int64),
        ttft_deadline=np.asarray(cols["ttft"], np.float64),
        deadline=np.asarray(cols["deadline"], np.float64))
    return trace.sorted_by_arrival()


def replay_csv(path: str) -> List[Request]:
    """Compatibility wrapper over :func:`replay_trace` for event-loop
    callers that want ``Request`` objects."""
    return replay_trace(path).to_requests()
