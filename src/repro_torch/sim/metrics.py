"""Metrics collection & reporting: TTFT/E2E percentiles, SLA violations,
instance-hours, wasted scaling hours, spot donations, memory-util traces."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.types import Request, TIER_IWF, TIER_IWN, TIER_NIW, TTFT_SLA

Key = Tuple[str, str]


def _pct(vals: Sequence[float], q: float) -> float:
    vals = np.asarray(vals, np.float64)
    vals = vals[~np.isnan(vals)]
    return float(np.percentile(vals, q)) if vals.size else math.nan


@dataclasses.dataclass
class Report:
    name: str
    ttft: Dict[str, Dict[str, float]]          # tier -> {p50,p75,p95,mean}
    e2e: Dict[str, Dict[str, float]]
    sla_violations: Dict[str, float]           # tier -> fraction
    completed: Dict[str, int]
    dropped: Dict[str, int]
    instance_hours: Dict[Key, float]
    wasted_hours: Dict[Key, float]
    spot_hours: Dict[str, float]
    scale_out_events: int
    scale_in_events: int
    util_trace: Dict[Key, List[Tuple[float, float, int]]]  # t, util, count
    retry_dropped: int = 0       # dropped after exhausting routing retries
    parked: int = 0              # still parked in the queue manager at end
    # dollar accounting: instance-hours priced by the stack's CostModel
    # (paper §7.2.1, α = $98.32/h by default)
    gpu_dollars: Dict[Key, float] = dataclasses.field(default_factory=dict)
    wasted_dollars: Dict[Key, float] = dataclasses.field(
        default_factory=dict)

    # ------------------------------------------------------------ summaries
    def total_instance_hours(self) -> float:
        return sum(self.instance_hours.values())

    def total_wasted_hours(self) -> float:
        return sum(self.wasted_hours.values())

    def total_spot_hours(self) -> float:
        return sum(self.spot_hours.values())

    def total_gpu_dollars(self) -> float:
        return sum(self.gpu_dollars.values())

    def total_wasted_dollars(self) -> float:
        return sum(self.wasted_dollars.values())

    def savings_vs(self, baseline: "Report") -> Dict[str, float]:
        """Dollar savings relative to a baseline run of the same trace
        (the paper's headline: LT-UA vs the reactive deployment)."""
        base = baseline.total_gpu_dollars()
        mine = self.total_gpu_dollars()
        return {"dollars": base - mine,
                "pct": 100.0 * (1.0 - mine / base) if base else 0.0}

    def summary(self) -> str:
        lines = [f"== {self.name} =="]
        for tier in (TIER_IWF, TIER_IWN, TIER_NIW):
            if tier not in self.ttft:
                continue
            t, e = self.ttft[tier], self.e2e[tier]
            lines.append(
                f"  {tier:5s} n={self.completed.get(tier, 0):7d} "
                f"TTFT p50={t['p50']:.2f}s p95={t['p95']:.2f}s | "
                f"E2E p95={e['p95']:.1f}s | "
                f"SLA viol={self.sla_violations.get(tier, 0)*100:.1f}%")
        lines.append(
            f"  instance-hours={self.total_instance_hours():.1f} "
            f"wasted={self.total_wasted_hours():.1f} "
            f"spot-donated={self.total_spot_hours():.1f} "
            f"scale-out={self.scale_out_events} in={self.scale_in_events}")
        if self.gpu_dollars:
            lines.append(
                f"  gpu-dollars=${self.total_gpu_dollars():,.0f} "
                f"wasted=${self.total_wasted_dollars():,.0f}")
        if self.retry_dropped or self.parked:
            lines.append(f"  retry-dropped={self.retry_dropped} "
                         f"parked={self.parked}")
        return "\n".join(lines)


def report_to_dict(rep: Report, include_util_trace: bool = True) -> Dict:
    """JSON-able view of a Report: tuple keys flattened to "model|region",
    NaNs to None.  Used by the perf benchmark and the golden-equivalence
    tests."""
    def clean(x):
        return None if (isinstance(x, float) and math.isnan(x)) else x

    d = {
        "name": rep.name,
        "ttft": {t: {k: clean(v) for k, v in d2.items()}
                 for t, d2 in rep.ttft.items()},
        "e2e": {t: {k: clean(v) for k, v in d2.items()}
                for t, d2 in rep.e2e.items()},
        "sla_violations": dict(rep.sla_violations),
        "completed": dict(rep.completed),
        "dropped": dict(rep.dropped),
        "instance_hours": {f"{m}|{r}": v
                           for (m, r), v in rep.instance_hours.items()},
        "wasted_hours": {f"{m}|{r}": v
                         for (m, r), v in rep.wasted_hours.items()},
        "spot_hours": dict(rep.spot_hours),
        "scale_out_events": rep.scale_out_events,
        "scale_in_events": rep.scale_in_events,
        "retry_dropped": rep.retry_dropped,
        "parked": rep.parked,
        "gpu_dollars": {f"{m}|{r}": v
                        for (m, r), v in rep.gpu_dollars.items()},
        "wasted_dollars": {f"{m}|{r}": v
                           for (m, r), v in rep.wasted_dollars.items()},
        "gpu_dollars_total": rep.total_gpu_dollars(),
        "wasted_dollars_total": rep.total_wasted_dollars(),
    }
    if include_util_trace:
        d["util_trace"] = {f"{m}|{r}": [[t, u, c] for (t, u, c) in tr]
                           for (m, r), tr in rep.util_trace.items()}
    return d


def build_report(name: str, requests: Sequence[Request], cluster,
                 util_trace: Dict[Key, List[Tuple[float, float, int]]],
                 retry_dropped: int = 0, parked: int = 0,
                 slo_ttft: Optional[Dict[str, float]] = None) -> Report:
    slo = TTFT_SLA if slo_ttft is None else slo_ttft
    ttft, e2e, viol, comp, drop = {}, {}, {}, {}, {}
    # one columnar pass over the trace (at 10M requests the old per-tier
    # object comprehensions dominated post-run wall-clock)
    groups: Dict[str, List[Request]] = {}
    for r in requests:
        groups.setdefault(r.tier, []).append(r)
    for tier in (TIER_IWF, TIER_IWN, TIER_NIW):
        rs = groups.get(tier)
        if not rs:
            continue
        n = len(rs)
        tt_all = np.fromiter((r.ttft for r in rs), np.float64, n)
        ee_all = np.fromiter((r.e2e for r in rs), np.float64, n)
        done = ~np.isnan(ee_all)
        n_done = int(done.sum())
        comp[tier] = n_done
        drop[tier] = n - n_done
        tt = tt_all[done]
        ee = ee_all[done]
        ttft[tier] = {"p50": _pct(tt, 50), "p75": _pct(tt, 75),
                      "p95": _pct(tt, 95),
                      "mean": float(np.mean(tt)) if n_done else math.nan}
        e2e[tier] = {"p50": _pct(ee, 50), "p75": _pct(ee, 75),
                     "p95": _pct(ee, 95),
                     "mean": float(np.mean(ee)) if n_done else math.nan}
        if tier in slo:
            bad = int((np.isnan(tt_all) | (tt_all > slo[tier])).sum())
        else:
            arr = np.fromiter((r.arrival for r in rs), np.float64, n)
            dl = np.fromiter((r.deadline for r in rs), np.float64, n)
            ok = done & (arr + ee_all <= dl)
            bad = n - int(ok.sum())
        viol[tier] = bad / n
    return Report(
        name=name, ttft=ttft, e2e=e2e, sla_violations=viol,
        completed=comp, dropped=drop,
        instance_hours=cluster.instance_hours(),
        wasted_hours=cluster.wasted_hours(),
        spot_hours=cluster.spot_hours(),
        scale_out_events=cluster.scale_out_events,
        scale_in_events=cluster.scale_in_events,
        util_trace=util_trace,
        retry_dropped=retry_dropped, parked=parked,
        gpu_dollars=cluster.gpu_dollars(),
        wasted_dollars=cluster.wasted_dollars())
