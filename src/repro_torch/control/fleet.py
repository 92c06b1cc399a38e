"""Fleet-wide forecast batching: one stacked fit per boundary.

A sweep steps many replicas in lockstep, and each replica's hourly
controller used to run its own ``BatchForecastEngine.fit_forecast`` —
one fit launch *per replica per boundary*.  The fits themselves are
pure per row (see the batch-purity contract in
:mod:`repro_torch.control.forecast`), so nothing stops stacking every
replica's (model, region) series into ONE call: boundary cost then
scales with hours, not replicas × hours.

:class:`FleetForecast` groups replica planners by their duck-typed
``forecast_spec`` capability (equal fit configurations may share a
batch), keeps one shared engine per spec with warm parameters
keyed ``(replica_id, model, region)`` — per-replica warmth is
preserved exactly, so the fitted parameters are bit-identical to each
replica running its own engine — and splits the fitted forecasts back
per replica for ``plan_fitted``.  Planners without the capability (or
with ``batched=False``) simply stay on their own per-replica path.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch import DeviceLike
from repro_torch.api.capabilities import capability
from repro_torch.control.forecast import BatchForecastEngine


class FleetForecast:
    """Coordinates one shared forecast engine per ``forecast_spec``
    group across a fleet of replica planners."""

    def __init__(self, planners: Dict[str, object],
                 device: DeviceLike = None):
        """``planners``: replica id → hourly planner (duck-typed);
        ``device``: where the shared engines fit (CUDA unless "cpu")."""
        self._spec: Dict[str, Tuple] = {}
        self._engines: Dict[Tuple, BatchForecastEngine] = {}
        for rid, pl in sorted(planners.items()):
            spec_fn = capability(pl, "forecast_spec")
            plan_fn = capability(pl, "plan_fitted")
            if spec_fn is None or plan_fn is None:
                continue
            spec = spec_fn()
            if spec is None:
                continue
            spec = tuple(spec)
            self._spec[rid] = spec
            if spec not in self._engines:
                p, d, q, s, steps, _horizon = spec
                self._engines[spec] = BatchForecastEngine(
                    p=p, d=d, q=q, seasonal_period=s, fit_steps=steps,
                    device=device)

    def batched(self, rid: str) -> bool:
        """Does this replica take the fleet path?"""
        return rid in self._spec

    def fit(self, histories: Dict[str, Dict]) -> Dict[str, Dict]:
        """One boundary: stack every fleet replica's series per spec
        group, fit each group with a single ``fit_forecast`` call, and
        return {replica id: {key: forecast}} for ``plan_fitted``.
        Replicas absent from ``self._spec`` are ignored (they forecast
        for themselves)."""
        out: Dict[str, Dict] = {rid: {} for rid in histories
                                if rid in self._spec}
        by_spec: Dict[Tuple, List[str]] = {}
        for rid in sorted(histories):
            spec = self._spec.get(rid)
            if spec is not None:
                by_spec.setdefault(spec, []).append(rid)
        for spec, rids in sorted(by_spec.items()):
            merged = {}
            for rid in rids:
                for key, series in histories[rid].items():
                    merged[(rid,) + tuple(key)] = series
            fitted = self._engines[spec].fit_forecast(merged, spec[-1])
            for fkey, fc in fitted.items():
                out[fkey[0]][fkey[1:]] = fc
        return out

    def stats(self) -> Dict[str, int]:
        """Aggregate fit/dedupe counters across the spec engines."""
        agg = {"fits": 0, "batches": 0, "unique_fits": 0,
               "dedup_hits": 0, "cache_hits": 0}
        for eng in self._engines.values():
            for k in agg:
                agg[k] += getattr(eng, k)
        agg["engines"] = len(self._engines)
        return agg
