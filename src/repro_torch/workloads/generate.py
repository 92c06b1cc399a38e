"""Vectorized compiler from :class:`WorkloadFamily` to columnar ``Trace``.

Same generation discipline as the base ``generate_trace`` path (see
docs/PERF.md): per (region, tier) the whole trace's Poisson counts,
arrival offsets, model picks and token lengths are drawn as numpy
arrays — no per-minute or per-session Python loops.  Multi-turn
sessions are the interesting part: turn arrivals, think-time gaps and
the per-turn context growth are all computed with segmented cumulative
sums over one flat array of turns (sessions are variable-length
segments delimited by ``np.repeat`` bookkeeping), so a million-turn
trace costs a handful of array ops.

Everything is deterministic from ``spec.seed`` via
``np.random.default_rng``; the carrying spec's scenario knobs
(pop_shifts, burst_*) compose on top of the family structure exactly as
they do on the base path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sim.types import (NIW_DEADLINE, TIER_IWF, TIER_IWN, TIER_NIW,
                             TTFT_SLA)
from repro_torch.sim.workload import _POP_IWF, _POP_NIW, _REGION_AMP, Trace, \
    WorkloadSpec

IW_DEADLINE = 30 * 60.0          # same e2e budget as the base generator


def _family_shape(hour_of_week: np.ndarray, diurnal_amp: float,
                  weekend_factor: float, weekly_amp: float) -> np.ndarray:
    """Rate shape: the base diurnal curve flattened toward 1 by
    ``diurnal_amp``, the family's own weekend quiescing, and an
    explicit weekly harmonic (period 168 h) for forecast seasonality
    tests to latch onto."""
    hw = np.asarray(hour_of_week, dtype=np.float64)
    dow = (hw // 24).astype(np.int64) % 7
    h = hw % 24
    base = 0.25 + 0.75 * np.maximum(
        0.0, np.sin(np.pi * (h - 7.0) / 14.0)) ** 1.5
    day = 1.0 + diurnal_amp * (base - 1.0)
    day = day * np.where(dow >= 5, weekend_factor, 1.0)
    week = 1.0 + weekly_amp * np.cos(2.0 * np.pi * (hw % 168.0) / 168.0)
    return day * week


def _flash_mult(hour_idx: np.ndarray, flash, region: str) -> np.ndarray:
    """Per-minute flash-crowd multiplier: linear ramp to peak_mult over
    ramp_minutes, then exponential decay (sharp front, long tail)."""
    m = np.ones_like(hour_idx)
    for c in flash:
        if c.regions is not None and region not in c.regions:
            continue
        t_min = (hour_idx - c.hour) * 60.0       # minutes since onset
        ramp = np.clip(t_min / c.ramp_minutes, 0.0, 1.0)
        decay = np.exp(-np.maximum(0.0, t_min - c.ramp_minutes)
                       / c.decay_minutes)
        m = m * (1.0 + (c.peak_mult - 1.0) * ramp * decay)
    return m


def _flood_mult(hour_idx: np.ndarray, floods) -> np.ndarray:
    """Per-minute NIW flood multiplier; daily windows repeat on the
    hour-of-day clock and may wrap past midnight."""
    m = np.ones_like(hour_idx)
    for f in floods:
        if f.daily:
            in_w = ((hour_idx % 24.0) - f.start_hour) % 24.0 < f.duration_h
        else:
            in_w = (hour_idx >= f.start_hour) & \
                (hour_idx < f.start_hour + f.duration_h)
        m = np.where(in_w, m * f.mult, m)
    return m


def _draw_prompts(rng: np.random.Generator, n: int,
                  lognorm: Tuple[float, float],
                  tail: Optional[Tuple[float, float, float]]) -> np.ndarray:
    """Lognormal body with an optional Pareto tail mixture — the
    heavy-tailed long-context regime the body alone cannot produce."""
    mu, sd = lognorm
    p = rng.lognormal(mu, sd, n)
    if tail is not None:
        frac, alpha, xm = tail
        is_tail = rng.uniform(0.0, 1.0, n) < frac
        k = int(is_tail.sum())
        if k:
            p[is_tail] = xm * (1.0 + rng.pareto(alpha, k))
    return np.clip(p, 16, 32768).astype(np.int64)


def _fit_pop(pop, n_models: int) -> np.ndarray:
    pop = list(pop)[:n_models]
    while len(pop) < n_models:
        pop.append(sum(pop) / len(pop))
    z = sum(pop)
    return np.asarray([x / z for x in pop])


def _pick_models(rng: np.random.Generator, times: np.ndarray,
                 pop: np.ndarray, models: Tuple[str, ...], region: str,
                 shifts) -> np.ndarray:
    """Model index per arrival, honouring hour-indexed PopularityShift
    windows (inverse-CDF sampling of per-arrival weight rows, same as
    the base generator's shifted branch)."""
    n = len(times)
    live = [s for s in shifts
            if s.regions is None or region in s.regions]
    if not live:
        return rng.choice(len(models), size=n, p=pop / pop.sum())
    w = np.tile(pop / pop.sum(), (n, 1))
    hours = times / 3600.0
    for s in live:
        mask = (hours >= s.start_hour) & (hours < s.end_hour)
        w[mask, models.index(s.model)] *= s.mult
    w /= w.sum(axis=1, keepdims=True)
    u = rng.uniform(0.0, 1.0, n)
    return np.minimum((u[:, None] > np.cumsum(w, axis=1)).sum(axis=1),
                      len(models) - 1)


def compile_family(spec: WorkloadSpec, fam) -> Trace:
    """Compile ``fam`` (a validated :class:`WorkloadFamily`) under the
    carrying spec's days/scale/seed/models/regions/start_dow and
    scenario knobs into a sorted columnar :class:`Trace`.

    Rate/mix/length calibration comes from the family; the spec's
    ``pop_shifts`` and ``burst_*`` compose on top (the fuzzer's axes).
    Session families additionally emit the ``Trace.session`` affinity
    column (-1 on non-session rows)."""
    fam.validate()
    rng = np.random.default_rng(spec.seed)
    minutes = int(spec.days * 24 * 60)
    duration_s = spec.days * 86400.0
    models = tuple(spec.models)
    regions = tuple(spec.regions)
    tiers = (TIER_IWF, TIER_IWN, TIER_NIW)
    for s in spec.pop_shifts:
        if s.model not in models:
            raise ValueError(
                f"pop_shifts: model {s.model!r} not in spec.models")
        for rg in s.regions or ():
            if rg not in regions:
                raise ValueError(
                    f"pop_shifts[{s.model!r}]: region {rg!r} not in "
                    f"spec.regions")

    mins = np.arange(minutes, dtype=np.float64)
    hour_idx = mins / 60.0
    minute_starts = mins * 60.0
    burst = np.ones(minutes)
    for bh in spec.burst_hours:
        burst[(hour_idx >= bh) & (hour_idx < bh + 1.0)] = spec.burst_mult
    flood = _flood_mult(hour_idx, fam.floods)

    sess = fam.sessions
    mean_turns = sess.mean_turns() if sess is not None else 1.0

    keys = ("model_idx", "region_idx", "tier_idx", "arrival",
            "prompt_tokens", "output_tokens", "ttft_deadline", "deadline",
            "session")
    cols: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
    next_sid = 0

    def _emit(tier_i: int, region_i: int, arrival, midx, prompts, outs,
              session_ids):
        n = len(arrival)
        if n == 0:
            return
        tier = tiers[tier_i]
        if tier == TIER_NIW:
            ttft_dl = arrival + NIW_DEADLINE
            dl = arrival + NIW_DEADLINE
        else:
            ttft_dl = arrival + TTFT_SLA[tier]
            dl = arrival + IW_DEADLINE
        cols["model_idx"].append(midx.astype(np.int16))
        cols["region_idx"].append(np.full(n, region_i, dtype=np.int16))
        cols["tier_idx"].append(np.full(n, tier_i, dtype=np.int16))
        cols["arrival"].append(arrival)
        cols["prompt_tokens"].append(prompts)
        cols["output_tokens"].append(outs)
        cols["ttft_deadline"].append(ttft_dl)
        cols["deadline"].append(dl)
        cols["session"].append(
            session_ids if session_ids is not None
            else np.full(n, -1, dtype=np.int64))

    for ri, region in enumerate(regions):
        amp = fam.region_amp.get(region, _REGION_AMP.get(region, 1.0))
        phase = fam.region_phase_h.get(region, 0.0)
        shape = _family_shape(
            spec.start_dow * 24 + hour_idx + phase,
            fam.diurnal_amp, fam.weekend_factor, fam.weekly_amp)
        sh = shape / max(float(np.mean(shape)), 1e-9)
        flash = _flash_mult(hour_idx, fam.flash, region)

        pop_iwf = _fit_pop(
            _POP_IWF.get(region, tuple([1 / len(models)] * len(models))),
            len(models))
        pop_niw = _fit_pop(
            _POP_NIW.get(region,
                         _POP_IWF.get(region,
                                      tuple([1 / len(models)]
                                            * len(models)))),
            len(models))
        iw_day = fam.iw_per_region_day * spec.scale * amp
        niw_day = fam.niw_per_region_day * spec.scale * amp
        lam_iw = iw_day / 1440.0 * sh * flash * burst
        lam_niw = niw_day / 1440.0 * flood       # flat apart from floods

        for ti, tier in enumerate(tiers):
            if tier == TIER_IWF:
                lam, pop = lam_iw * fam.iwf_frac_of_iw, pop_iwf
            elif tier == TIER_IWN:
                lam, pop = lam_iw * (1 - fam.iwf_frac_of_iw), pop_iwf
            else:
                lam, pop = lam_niw, pop_niw

            if sess is not None and tier != TIER_NIW:
                # ---- multi-turn sessions (segmented-cumsum, no loops)
                counts = rng.poisson(lam / mean_turns)
                ns = int(counts.sum())
                if ns == 0:
                    continue
                starts = np.repeat(minute_starts, counts) + \
                    rng.uniform(0, 60.0, ns)
                tmu, tsd = sess.turns_lognorm
                turns = np.clip(np.rint(rng.lognormal(tmu, tsd, ns)),
                                1, sess.max_turns).astype(np.int64)
                total = int(turns.sum())
                idx0 = np.cumsum(turns) - turns        # segment heads
                gmu, gsd = sess.think_lognorm
                gaps = rng.lognormal(gmu, gsd, total)
                gaps[idx0] = 0.0                       # turn 0 = start
                cg = np.cumsum(gaps)
                within = cg - np.repeat(cg[idx0], turns)
                arrival = np.repeat(starts, turns) + within
                # one model per session: that is the KV-affinity point
                midx_s = _pick_models(rng, starts, pop, models, region,
                                      spec.pop_shifts)
                midx = np.repeat(midx_s, turns)
                # context growth: turn i resends carry × all prior
                # turns' tokens plus its own fresh text.  hist_excl is
                # an exclusive segmented cumsum of per-turn tokens.
                fmu, fsd = sess.fresh_lognorm
                fresh = rng.lognormal(fmu, fsd, total)
                outs = np.clip(rng.lognormal(*fam.output_lognorm, total),
                               1, 4096).astype(np.int64)
                tok = fresh + outs
                ct = np.cumsum(tok)
                cinc = ct - np.repeat(ct[idx0] - tok[idx0], turns)
                hist_excl = cinc - tok
                prompts = np.clip(
                    fresh + sess.context_carry * hist_excl,
                    16, 32768).astype(np.int64)
                sids = np.repeat(
                    np.arange(ns, dtype=np.int64) + next_sid, turns)
                next_sid += ns
                # later turns can spill past the trace end; clip them
                keep = arrival < duration_s
                _emit(ti, ri, arrival[keep], midx[keep], prompts[keep],
                      outs[keep], sids[keep])
            else:
                counts = rng.poisson(lam)
                n = int(counts.sum())
                if n == 0:
                    continue
                arrival = np.repeat(minute_starts, counts) + \
                    rng.uniform(0, 60.0, n)
                midx = _pick_models(rng, arrival, pop, models, region,
                                    spec.pop_shifts)
                prompts = _draw_prompts(rng, n, fam.prompt_lognorm,
                                        fam.prompt_tail)
                outs = np.clip(rng.lognormal(*fam.output_lognorm, n),
                               1, 4096).astype(np.int64)
                _emit(ti, ri, arrival, midx, prompts, outs, None)

    def _empty(k):
        if k.endswith("idx"):
            return np.zeros(0, dtype=np.int16)
        if k.endswith("tokens") or k == "session":
            return np.zeros(0, dtype=np.int64)
        return np.zeros(0, dtype=np.float64)

    cat = {k: (np.concatenate(v) if v else _empty(k))
           for k, v in cols.items()}
    session_col = cat.pop("session")
    total = int(cat["arrival"].shape[0])
    trace = Trace(models=models, regions=regions, tiers=tiers,
                  rid=np.arange(total, dtype=np.int64),
                  session=(session_col if sess is not None else None),
                  **cat)
    return trace.sorted_by_arrival()
