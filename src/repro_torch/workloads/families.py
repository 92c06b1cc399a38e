"""Named, calibrated workload families (the ServeGen-grade library).

A :class:`WorkloadFamily` is a declarative description of *structured*
production traffic — everything the flat Poisson-with-diurnal base
generator cannot express:

- multi-turn conversation **sessions** with think-time gaps, growing
  per-turn context (KV-reuse), and a session affinity tag per request;
- **heavy-tailed** context lengths (lognormal body + Pareto tail);
- per-region diurnal **phase shifts** and amplitudes (follow-the-sun
  mixes) plus weekend quiescing and an explicit weekly harmonic;
- scheduled **NIW floods** (nightly report/batch-ingest runs);
- **flash crowds** (minutes-scale ramp to a multiple of steady rate,
  exponential decay);
- **spot-preemption storms** (correlated short capacity losses, carried
  as scenario outage windows rather than arrivals).

Families ride inside ``WorkloadSpec.family``: ``generate_trace``
dispatches to :func:`repro_torch.workloads.generate.compile_family`, so the
whole experiment layer (trace memoization, spill files, the vector
engine) consumes family traces with zero changes.  The spec's own
``days / scale / seed / models / regions / start_dow / pop_shifts /
burst_*`` knobs still apply on top, which is exactly the surface the
scenario fuzzer composes its axes on.

Calibration sources (see docs/WORKLOADS.md for the full table): the
paper's §3 volume/tier/diurnal anchors, ServeGen's client-level
structure findings (multi-turn ratios, heavy-tailed lengths, per-region
seasonality), and BurstGPT-style flash-crowd shapes.  Numbers are
matched to published statistics, not copied traces.

Every class here round-trips ``to_dict``/``from_dict`` (strict —
unknown keys rejected) and ``validate``s with actionable messages,
mirroring ``WorkloadSpec``.  This module deliberately imports only the
sim layer; the fuzzer (``repro_torch.workloads.fuzz``) is where the api-layer
specs come in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.sim.workload import Trace, WorkloadSpec


def strict_from_dict(cls, d: Mapping):
    # same strict contract as repro_torch.api.spec.strict_from_dict, kept
    # inline: the family layer does not import the api layer
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**dict(d))


def _plain(v):
    """JSON-able view of one field value: nested components via their
    own ``to_dict``, tuples as lists, dicts copied."""
    if hasattr(v, "to_dict"):
        return v.to_dict()
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return dict(v)
    return v


# ---------------------------------------------------------------- components
@dataclasses.dataclass(frozen=True)
class SessionProfile:
    """Multi-turn conversation structure (chat families).

    Sessions start as a Poisson process at the family's diurnal rate
    divided by the mean turn count, so the *turn* volume still matches
    the family's per-day anchor.  Turn ``i`` of a session arrives one
    think-time gap after turn ``i-1``; its prompt is that turn's fresh
    text plus ``context_carry`` × all prior turns' tokens — the growing
    resent context that KV-reuse-affine routing exists to exploit.  All
    turns of a session share one model, one region, and one session id
    (``Trace.session``)."""

    turns_lognorm: Tuple[float, float] = (1.25, 0.6)   # median ~3.5 turns
    think_lognorm: Tuple[float, float] = (3.4, 0.8)    # median ~30 s gaps
    fresh_lognorm: Tuple[float, float] = (5.9, 0.9)    # fresh text ~365 tok
    context_carry: float = 0.9     # fraction of prior tokens resent
    max_turns: int = 32

    def __post_init__(self):
        object.__setattr__(self, "turns_lognorm",
                           tuple(self.turns_lognorm))
        object.__setattr__(self, "think_lognorm",
                           tuple(self.think_lognorm))
        object.__setattr__(self, "fresh_lognorm",
                           tuple(self.fresh_lognorm))

    def validate(self) -> "SessionProfile":
        if not 0.0 <= self.context_carry <= 1.0:
            raise ValueError(
                f"SessionProfile.context_carry must be in [0, 1] (got "
                f"{self.context_carry})")
        if self.max_turns < 1:
            raise ValueError("SessionProfile.max_turns must be >= 1")
        for name in ("turns_lognorm", "think_lognorm", "fresh_lognorm"):
            mu, sd = getattr(self, name)
            if sd < 0:
                raise ValueError(
                    f"SessionProfile.{name} sigma must be >= 0 (got {sd})")
        return self

    def mean_turns(self) -> float:
        """Analytic mean of the (unclipped) turn-count lognormal — the
        factor session rate is divided by so turn volume matches the
        family anchor.  Clipping to [1, max_turns] shifts this slightly;
        the statistical tests carry the tolerance."""
        mu, sd = self.turns_lognorm
        return float(np.exp(mu + 0.5 * sd * sd))

    def to_dict(self) -> Dict:
        return {f.name: _plain(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "SessionProfile":
        return strict_from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class FloodWindow:
    """A scheduled NIW flood: within the window the NIW arrival rate is
    multiplied by ``mult`` (nightly report generation, batch ingest).
    ``daily=True`` interprets ``start_hour`` as hour-of-day and repeats
    the window every day (wrap past midnight allowed); ``daily=False``
    is a one-shot window at absolute trace hours."""

    start_hour: float
    duration_h: float
    mult: float
    daily: bool = True

    def validate(self) -> "FloodWindow":
        if self.mult < 0:
            raise ValueError(
                f"FloodWindow.mult must be >= 0 (got {self.mult})")
        if self.duration_h <= 0:
            raise ValueError(
                f"FloodWindow.duration_h must be positive (got "
                f"{self.duration_h})")
        if self.daily and not 0.0 <= self.start_hour < 24.0:
            raise ValueError(
                f"daily FloodWindow.start_hour must be an hour-of-day in "
                f"[0, 24) (got {self.start_hour})")
        if not self.daily and self.start_hour < 0:
            raise ValueError(
                f"FloodWindow.start_hour must be >= 0 (got "
                f"{self.start_hour})")
        return self

    def to_dict(self) -> Dict:
        return {f.name: _plain(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "FloodWindow":
        return strict_from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """A flash crowd on the IW tiers: starting at ``hour`` the arrival
    rate ramps linearly to ``peak_mult`` × steady over ``ramp_minutes``,
    then decays exponentially with time constant ``decay_minutes``
    (BurstGPT-style shape: sharp front, long tail).  ``regions`` limits
    the crowd (None = everywhere)."""

    hour: float
    peak_mult: float
    ramp_minutes: float = 5.0
    decay_minutes: float = 45.0
    regions: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.regions is not None:
            object.__setattr__(self, "regions", tuple(self.regions))

    def validate(self) -> "FlashCrowd":
        if self.hour < 0:
            raise ValueError(
                f"FlashCrowd.hour must be >= 0 (got {self.hour})")
        if self.peak_mult < 1.0:
            raise ValueError(
                f"FlashCrowd.peak_mult must be >= 1 (got "
                f"{self.peak_mult}); a crowd below steady rate is not a "
                f"crowd")
        if self.ramp_minutes <= 0 or self.decay_minutes <= 0:
            raise ValueError(
                "FlashCrowd ramp_minutes/decay_minutes must be positive")
        return self

    def to_dict(self) -> Dict:
        return {f.name: _plain(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "FlashCrowd":
        return strict_from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class PreemptionStorm:
    """Correlated spot-preemption storm, expressed as scenario capacity
    windows rather than arrivals: ``events`` short regional outages with
    exponentially-distributed durations around ``mean_duration_min``,
    scattered uniformly over [``start_hour``, ``end_hour``] (None = the
    trace end).  :meth:`to_windows` derives the concrete, deterministic
    (region, start_s, end_s) windows — overlapping same-region windows
    are merged so outage actuation never double-fires."""

    events: int = 6
    mean_duration_min: float = 10.0
    start_hour: float = 0.0
    end_hour: Optional[float] = None
    regions: Optional[Tuple[str, ...]] = None
    salt: int = 0           # decorrelates storms sharing a workload seed

    def __post_init__(self):
        if self.regions is not None:
            object.__setattr__(self, "regions", tuple(self.regions))

    def validate(self) -> "PreemptionStorm":
        if self.events < 1:
            raise ValueError(
                f"PreemptionStorm.events must be >= 1 (got {self.events})")
        if self.mean_duration_min <= 0:
            raise ValueError(
                "PreemptionStorm.mean_duration_min must be positive")
        if self.start_hour < 0:
            raise ValueError(
                "PreemptionStorm.start_hour must be >= 0")
        if self.end_hour is not None and self.end_hour <= self.start_hour:
            raise ValueError(
                f"PreemptionStorm.end_hour {self.end_hour} must be past "
                f"start_hour {self.start_hour}")
        return self

    def to_windows(self, days: float, regions: Tuple[str, ...],
                   seed: int) -> Tuple[Tuple[str, float, float], ...]:
        """Deterministic (region, start_s, end_s) outage windows."""
        rgs = tuple(self.regions) if self.regions else tuple(regions)
        rng = np.random.default_rng(
            (int(seed) * 1000003 + self.salt * 7919 + 17) % (2 ** 32))
        end_h = self.end_hour if self.end_hour is not None else days * 24.0
        end_h = min(end_h, days * 24.0)
        starts = np.sort(rng.uniform(self.start_hour * 3600.0,
                                     end_h * 3600.0, self.events))
        durs = np.clip(rng.exponential(self.mean_duration_min * 60.0,
                                       self.events), 120.0, 2 * 3600.0)
        picks = rng.integers(0, len(rgs), self.events)
        per_region: Dict[str, List[List[float]]] = {}
        for s, d, p in zip(starts, durs, picks):
            e = min(float(s + d), days * 86400.0)
            if e <= s:
                continue
            win = per_region.setdefault(rgs[int(p)], [])
            if win and s <= win[-1][1]:
                win[-1][1] = max(win[-1][1], e)     # merge overlap
            else:
                win.append([float(s), e])
        out = [(rg, s, e) for rg in sorted(per_region)
               for s, e in per_region[rg]]
        return tuple(sorted(out, key=lambda w: (w[1], w[0])))

    def to_dict(self) -> Dict:
        return {f.name: _plain(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "PreemptionStorm":
        return strict_from_dict(cls, d)


# ------------------------------------------------------------------ families
_COMPONENT_TYPES = {
    "sessions": SessionProfile,
    "preemption": PreemptionStorm,
}


@dataclasses.dataclass
class WorkloadFamily:
    """One named, calibrated traffic family.  Rate/mix/length knobs are
    authoritative here (they replace the carrying ``WorkloadSpec``'s);
    structure components are optional and compose freely."""

    name: str
    description: str = ""

    # volume & tier mix (per-region-day at scale=1; paper §3 anchors)
    iw_per_region_day: float = 1.4e6
    niw_per_region_day: float = 0.2e6
    iwf_frac_of_iw: float = 0.65

    # seasonality: diurnal depth, weekend quiescing, weekly harmonic,
    # per-region phase shift (hours) and amplitude override
    diurnal_amp: float = 1.0
    weekend_factor: float = 0.35
    weekly_amp: float = 0.0
    region_phase_h: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    region_amp: Dict[str, float] = dataclasses.field(default_factory=dict)

    # token lengths: lognormal body + optional Pareto tail
    # (tail_frac, pareto_alpha, tail_min_tokens)
    prompt_lognorm: Tuple[float, float] = (7.2, 1.0)
    output_lognorm: Tuple[float, float] = (5.2, 0.9)
    prompt_tail: Optional[Tuple[float, float, float]] = None

    # structure components
    sessions: Optional[SessionProfile] = None
    floods: Tuple[FloodWindow, ...] = ()
    flash: Tuple[FlashCrowd, ...] = ()
    preemption: Optional[PreemptionStorm] = None

    def __post_init__(self):
        self.prompt_lognorm = tuple(self.prompt_lognorm)
        self.output_lognorm = tuple(self.output_lognorm)
        if self.prompt_tail is not None:
            self.prompt_tail = tuple(self.prompt_tail)
        self.region_phase_h = dict(self.region_phase_h)
        self.region_amp = dict(self.region_amp)
        for fname, ftype in _COMPONENT_TYPES.items():
            v = getattr(self, fname)
            if isinstance(v, Mapping):
                setattr(self, fname, ftype.from_dict(v))
        self.floods = tuple(
            f if isinstance(f, FloodWindow) else FloodWindow.from_dict(f)
            for f in self.floods)
        self.flash = tuple(
            f if isinstance(f, FlashCrowd) else FlashCrowd.from_dict(f)
            for f in self.flash)

    # -------------------------------------------------------------- validate
    def validate(self) -> "WorkloadFamily":
        if not self.name:
            raise ValueError("WorkloadFamily.name must be non-empty")
        for knob in ("iw_per_region_day", "niw_per_region_day"):
            if getattr(self, knob) < 0:
                raise ValueError(f"WorkloadFamily.{knob} must be >= 0")
        if not 0.0 <= self.iwf_frac_of_iw <= 1.0:
            raise ValueError(
                "WorkloadFamily.iwf_frac_of_iw must be in [0, 1]")
        if not 0.0 <= self.diurnal_amp <= 1.0:
            raise ValueError(
                f"WorkloadFamily.diurnal_amp must be in [0, 1] (got "
                f"{self.diurnal_amp}); 0 = flat, 1 = full diurnal swing")
        if self.weekend_factor <= 0:
            raise ValueError(
                "WorkloadFamily.weekend_factor must be positive")
        if not 0.0 <= self.weekly_amp < 1.0:
            raise ValueError(
                "WorkloadFamily.weekly_amp must be in [0, 1)")
        for rg, a in self.region_amp.items():
            if a < 0:
                raise ValueError(
                    f"WorkloadFamily.region_amp[{rg!r}] must be >= 0")
        if self.prompt_tail is not None:
            frac, alpha, xm = self.prompt_tail
            if not 0.0 <= frac < 1.0:
                raise ValueError(
                    "prompt_tail fraction must be in [0, 1)")
            if alpha <= 1.0:
                raise ValueError(
                    f"prompt_tail Pareto alpha must be > 1 (got {alpha}; "
                    f"alpha <= 1 has no finite mean)")
            if xm <= 0:
                raise ValueError("prompt_tail min tokens must be positive")
        if self.sessions is not None:
            self.sessions.validate()
        for f in self.floods:
            f.validate()
        for f in self.flash:
            f.validate()
        if self.preemption is not None:
            self.preemption.validate()
        return self

    # --------------------------------------------------------------- compile
    def compile(self, spec: WorkloadSpec) -> Trace:
        """Compile this family under the carrying spec's days / scale /
        seed / models / regions / scenario knobs into a columnar
        ``Trace`` (the ``generate_trace`` dispatch target)."""
        from repro_torch.workloads.generate import compile_family
        return compile_family(spec, self)

    # ------------------------------------------------------------- dict I/O
    def to_dict(self) -> Dict:
        return {f.name: _plain(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "WorkloadFamily":
        return strict_from_dict(cls, d)


# ------------------------------------------------------------------- catalog
def _catalog() -> Dict[str, WorkloadFamily]:
    fams = (
        WorkloadFamily(
            name="steady-diurnal",
            description="Baseline interactive chat: the paper's §3 "
                        "volume/tier anchors, diurnal with weekend "
                        "quiescing, lognormal lengths."),
        WorkloadFamily(
            name="chat-sessions",
            description="Multi-turn conversations: think-time gaps, "
                        "context growing ~90% carry per turn, session "
                        "affinity tags for KV reuse (ServeGen client "
                        "structure).",
            sessions=SessionProfile(),
            # fresh text per turn is shorter than one-shot prompts; the
            # carried context rebuilds the long effective prompt
            prompt_lognorm=(5.9, 0.9)),
        WorkloadFamily(
            name="longctx-summarize",
            description="Heavy-tailed long-context summarization: 20% "
                        "Pareto(1.8) tail from 4k tokens, short "
                        "outputs, lower volume.",
            iw_per_region_day=0.5e6,
            prompt_lognorm=(7.6, 1.1),
            output_lognorm=(4.6, 0.8),
            prompt_tail=(0.20, 1.8, 4096.0)),
        WorkloadFamily(
            name="niw-report-flood",
            description="Nightly scheduled NIW report/batch floods: "
                        "8x NIW rate for 2h starting 00:30 and a "
                        "smaller 14:00 ingest window, every day.",
            niw_per_region_day=0.45e6,
            floods=(FloodWindow(start_hour=0.5, duration_h=2.0, mult=8.0),
                    FloodWindow(start_hour=14.0, duration_h=1.0,
                                mult=3.0))),
        WorkloadFamily(
            name="flash-crowd",
            description="Flash crowds: global 6x spike at 10:00 (5-min "
                        "ramp, 45-min decay) and an eastus-only 4x at "
                        "19:30 (BurstGPT-style shape).",
            flash=(FlashCrowd(hour=10.0, peak_mult=6.0),
                   FlashCrowd(hour=19.5, peak_mult=4.0,
                              ramp_minutes=3.0, decay_minutes=30.0,
                              regions=("eastus",)))),
        WorkloadFamily(
            name="preemption-storm",
            description="Spot-preemption storm: 8 correlated regional "
                        "capacity losses (~12 min each) across the "
                        "day, steady diurnal arrivals underneath.",
            preemption=PreemptionStorm(events=8, mean_duration_min=12.0)),
        WorkloadFamily(
            name="region-shifted",
            description="Follow-the-sun multi-geo mix: +8h/-3h diurnal "
                        "phase shifts and rebalanced regional "
                        "amplitudes, weekly harmonic on top.",
            weekly_amp=0.15,
            region_phase_h={"eastus": 0.0, "westus": -3.0,
                            "centralus": 8.0},
            region_amp={"eastus": 1.2, "westus": 1.0, "centralus": 0.9}),
    )
    return {f.name: f.validate() for f in fams}


#: the named family library; treat as read-only (copy before editing)
FAMILIES: Dict[str, WorkloadFamily] = _catalog()


def family_workload(name: str, days: float = 1.0, scale: float = 0.05,
                    seed: int = 0, **spec_kwargs) -> WorkloadSpec:
    """A ``WorkloadSpec`` carrying the named family — the one-liner the
    fuzzer and benchmarks build scenarios from."""
    fam = FAMILIES.get(name)
    if fam is None:
        raise KeyError(f"no workload family named {name!r}; known: "
                       f"{', '.join(sorted(FAMILIES))}")
    return WorkloadSpec(days=days, scale=scale, seed=seed, family=fam,
                        **spec_kwargs)
