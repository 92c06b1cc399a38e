"""Bucketed views of a columnar ``Trace`` for the vector engine.

The fluid core advances in fixed ``dt``-second buckets, so all it needs
from the workload is per-bucket aggregate inflow: arrival counts and
prompt/output token sums per (bucket, model, home-region), split into
the IW-routed group and the NIW group (parked when a queue manager is
present).  Everything here is plain numpy built with ``bincount`` over
the trace columns — a zero-copy *view* of the trace rides along for the
per-request post-processing pass (``repro_torch.sim.vector.report``), so no
``Request`` objects are ever materialized on this path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.sim.types import TIER_NIW
from repro_torch.sim.workload import Trace


@dataclasses.dataclass
class BucketedTrace:
    """Per-bucket aggregate inflow arrays, shape ``[B, M, J]``.

    ``iw_*`` covers the tiers the simulator routes on arrival (IW-F and
    IW-N — plus NIW when the stack has no queue manager, which the
    engine handles by adding ``niw_*`` into the routed flow).  Arrivals
    whose prompt+output exceed the model's KV capacity are *excluded*
    (``rejected`` marks them per-request): the event loop can never
    start them and they surface straight in the drop accounting.
    """

    trace: Trace                 # zero-copy reference to the columns
    dt: float
    n_buckets: int
    horizon: float
    # routed (IW) inflow: count / prompt tokens / output tokens
    iw_n: np.ndarray
    iw_p: np.ndarray
    iw_o: np.ndarray
    # NIW inflow (parked by a queue manager when present)
    niw_n: np.ndarray
    niw_p: np.ndarray
    niw_o: np.ndarray
    # trailing-300s observed prompt-TPS per (model, home region), the
    # shape ``Scaler.on_tick`` views carry (includes rejected arrivals:
    # the event loop notes TPS before admission)
    obs_tps: np.ndarray
    # per-request bucket index + KV-capacity rejection mask
    req_bucket: np.ndarray       # int64 [N]
    rejected: np.ndarray         # bool  [N]
    # planner history: prompt-token bucket sums at ``hist_window``
    # seconds per (model, region) — all tiers, and NIW-only (for
    # ``niw_last_hour``), matching ``TpsHistory`` note() values
    hist_window: float
    hist_p: np.ndarray           # [Bw, M, J] float64
    niw_hist_p: np.ndarray       # [Bw, M, J] float64
    # cache for lagged force-release cumulative floors keyed by
    # (promote_age, deadline_slack)
    _fcum_cache: Dict[Tuple[float, float], np.ndarray] = \
        dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------- helpers
    def force_release_cum(self, promote_age: float,
                          slack: float) -> np.ndarray:
        """Cumulative count of NIW requests whose queue-manager
        force-release time (``min(arrival + promote_age, deadline -
        slack)``) has passed by each bucket's start, per (bucket, model).
        The engine uses it as a floor on total releases — FIFO order
        makes the count-based floor exact."""
        key = (float(promote_age), float(slack))
        hit = self._fcum_cache.get(key)
        if hit is not None:
            return hit
        tr = self.trace
        niw_ti = tr.tiers.index(TIER_NIW) if TIER_NIW in tr.tiers else -1
        sel = (tr.tier_idx == niw_ti) & ~self.rejected
        M = len(tr.models)
        B = self.n_buckets
        rel_t = np.minimum(tr.arrival[sel] + promote_age,
                           tr.deadline[sel] - slack)
        b = np.clip((rel_t / self.dt).astype(np.int64), 0, B - 1)
        flat = tr.model_idx[sel].astype(np.int64) * B + b
        per = np.bincount(flat, minlength=M * B).reshape(M, B)
        out = np.cumsum(per, axis=1).T.astype(np.float64)  # [B, M]
        self._fcum_cache[key] = out
        return out

    def planner_series(self, now: float, lookback: float
                       ) -> Dict[Tuple[str, str], np.ndarray]:
        """``Simulation.history_series`` equivalent: per-(model, region)
        bucket sums for buckets [0, now), clipped to the lookback."""
        w = self.hist_window
        bw = int(now / w)
        cap = max(int(math.ceil(lookback / w)), 2)
        lo = max(0, bw - cap)
        tr = self.trace
        return {(m, r): self.hist_p[lo:bw, mi, ji].copy()
                for mi, m in enumerate(tr.models)
                for ji, r in enumerate(tr.regions)}

    def niw_last_hour(self, now: float) -> Dict[Tuple[str, str], float]:
        """``Simulation.niw_last_hour``: mean NIW bucket value over the
        trailing hour, excluding the current bucket."""
        w = self.hist_window
        bw = int(now / w)
        nb = max(int(3600.0 / w), 1)
        lo = max(0, bw - nb)
        tr = self.trace
        seg = self.niw_hist_p[lo:bw]
        tot = seg.sum(axis=0) / nb
        return {(m, r): float(tot[mi, ji])
                for mi, m in enumerate(tr.models)
                for ji, r in enumerate(tr.regions)}


def bucketize(trace: Trace, dt: float, horizon: float,
              kv_caps: Dict[str, int],
              obs_horizon: float = 300.0,
              hist_window: float = 60.0) -> BucketedTrace:
    """Build per-bucket aggregate arrays from a sorted columnar trace.

    ``kv_caps`` maps model name → ``kv_capacity_tokens`` (requests that
    cannot fit are rejected up front, exactly as the event loop's
    admission check would).  NIW rows always land in the ``niw_*``
    group; the engine merges them into the routed flow for replicas
    without a queue manager, so one bucketing serves both kinds.
    """
    M, J = len(trace.models), len(trace.regions)
    B = max(int(math.ceil(horizon / dt)), 1) + 1
    n = len(trace)

    caps = np.asarray([kv_caps[m] for m in trace.models], dtype=np.int64)
    rejected = (trace.prompt_tokens + trace.output_tokens) > \
        caps[trace.model_idx.astype(np.int64)]
    req_bucket = np.clip((trace.arrival / dt).astype(np.int64), 0, B - 1)

    niw_ti = trace.tiers.index(TIER_NIW) if TIER_NIW in trace.tiers else -1
    is_niw = trace.tier_idx == niw_ti

    flat = (req_bucket * M + trace.model_idx.astype(np.int64)) * J \
        + trace.region_idx.astype(np.int64)
    size = B * M * J

    def _sums(sel: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        f = flat[sel]
        cnt = np.bincount(f, minlength=size).reshape(B, M, J)
        p = np.bincount(f, weights=trace.prompt_tokens[sel].astype(
            np.float64), minlength=size).reshape(B, M, J)
        o = np.bincount(f, weights=trace.output_tokens[sel].astype(
            np.float64), minlength=size).reshape(B, M, J)
        return (cnt.astype(np.float64), p, o)

    ok = ~rejected
    iw_n, iw_p, iw_o = _sums(ok & ~is_niw)
    niw_n, niw_p, niw_o = _sums(ok & is_niw)

    # trailing obs_horizon prompt-TPS (all arrivals, incl. rejected —
    # the event loop notes TPS at arrival, before admission)
    all_p = np.bincount(flat, weights=trace.prompt_tokens.astype(
        np.float64), minlength=size).reshape(B, M, J)
    w = max(int(round(obs_horizon / dt)), 1)
    cs = np.cumsum(all_p, axis=0)
    obs = np.empty_like(cs)
    obs[:w] = cs[:w]
    obs[w:] = cs[w:] - cs[:-w]
    obs /= obs_horizon

    # planner history at hist_window buckets (TpsHistory note value is
    # prompt_tokens / window, bucket sums follow)
    Bw = int(horizon / hist_window) + 2
    bh = np.minimum((trace.arrival / hist_window).astype(np.int64), Bw - 1)
    fh = (bh * M + trace.model_idx.astype(np.int64)) * J \
        + trace.region_idx.astype(np.int64)
    wvals = trace.prompt_tokens.astype(np.float64) / hist_window
    hist_p = np.bincount(fh, weights=wvals,
                         minlength=Bw * M * J).reshape(Bw, M, J)
    niw_hist_p = np.bincount(fh[is_niw], weights=wvals[is_niw],
                             minlength=Bw * M * J).reshape(Bw, M, J)

    return BucketedTrace(
        trace=trace, dt=float(dt), n_buckets=B, horizon=float(horizon),
        iw_n=iw_n, iw_p=iw_p, iw_o=iw_o,
        niw_n=niw_n, niw_p=niw_p, niw_o=niw_o,
        obs_tps=obs, req_bucket=req_bucket, rejected=rejected,
        hist_window=float(hist_window), hist_p=hist_p,
        niw_hist_p=niw_hist_p)
