"""Per-replica ``Report`` assembly for the vector engine.

The kernel emits per-bucket aggregate signals (expected queueing delay,
TBT and NIW park wait per (cell, home region)); each request's TTFT/E2E
is reconstructed from the bucket it arrived in — a vectorized gather
per segment, no Python ``Request`` objects.  Latency distributions are
held as log-spaced histograms (fixed memory, ~1% bin resolution) plus
exact sums, so percentiles/means come out without storing per-request
arrays; instance/waste/spot seconds accumulate in float64.

Counts are fluid: drops from dead cells and end-of-run leftovers are
real-valued per cell and get allocated to tiers by each cell's arrival
mix, then rounded.  The parity contract (docs/PERF.md) is on completion
fraction, instance-hours and gpu_dollars — not on per-tier tails.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.control.cost import CostModel
from repro_torch.sim.metrics import Report
from repro_torch.sim.types import TIER_NIW, TTFT_SLA

Key = Tuple[str, str]

_BINS = np.geomspace(1e-4, 1e7, 1024)


def _percentile(hist: np.ndarray, q: float) -> float:
    tot = hist.sum()
    if tot <= 0:
        return float("nan")
    cum = np.cumsum(hist)
    i = int(np.searchsorted(cum, q * tot))
    i = min(i, len(_BINS) - 2)
    return float(math.sqrt(_BINS[i] * _BINS[i + 1]))


class ReplicaAccumulator:
    def __init__(self, rp, st, bk):
        self.rp, self.st, self.bk = rp, st, bk
        tr = bk.trace
        self.tiers = list(tr.tiers)
        self.dt = st.dt
        niw_ti = (tr.tiers.index(TIER_NIW)
                  if TIER_NIW in tr.tiers else -1)
        self._mi = tr.model_idx.astype(np.int64)
        self._ji = tr.region_idx.astype(np.int64)
        self._ti = tr.tier_idx.astype(np.int64)
        is_niw = self._ti == niw_ti
        self._cell = self._mi * st.P + np.where(is_niw, st.niw_pool, 0)
        self._is_niw = is_niw
        self._arr = tr.arrival
        self._prompt = tr.prompt_tokens.astype(np.float64)
        self._otok = tr.output_tokens.astype(np.float64)
        self._deadline = tr.deadline
        self._rej = bk.rejected
        self._rb = bk.req_bucket
        T = len(self.tiers)
        self.n_tier = np.bincount(self._ti, minlength=T).astype(np.int64)
        self.rej_tier = np.bincount(self._ti[self._rej],
                                    minlength=T).astype(np.int64)
        # per-cell tier mix of non-rejected arrivals, for allocating
        # fluid drops back to tiers
        ok = ~self._rej
        self.mix = np.zeros((st.C, T))
        np.add.at(self.mix, (self._cell[ok], self._ti[ok]), 1.0)
        nb = len(_BINS) - 1
        self.h_ttft = np.zeros((T, nb))
        self.h_e2e = np.zeros((T, nb))
        self.sum_ttft = np.zeros(T)
        self.sum_e2e = np.zeros(T)
        self.cnt = np.zeros(T, np.int64)
        self.slo_bad = np.zeros(T, np.int64)    # est. TTFT over SLO
        self.niw_ontime = np.zeros(T, np.int64)
        self.inst_sec = np.zeros((st.C, st.J))
        self.waste_sec = np.zeros((st.C, st.J))
        self.spot_sec = np.zeros(st.J)
        self.drop_cell = np.zeros(st.C)
        self.so = 0.0
        self.si = 0.0
        self.util_trace: Dict[Key, List[Tuple[float, float, int]]] = \
            {(m, r): [] for m in st.models for r in st.regions}
        self._sample_b = max(int(round(rp.cfg.sample_every / st.dt)), 1)
        slo = rp.cfg.slo_ttft if rp.cfg.slo_ttft is not None else TTFT_SLA
        self.slo = np.asarray([slo.get(t, np.inf) for t in self.tiers])

    # ---------------------------------------------------------------- ingest
    def ingest(self, b0: int, ys: Dict[str, np.ndarray]) -> None:
        st, dt = self.st, self.dt
        S = ys["inst"].shape[0]
        self.inst_sec += ys["inst"].sum(axis=0, dtype=np.float64) * dt
        self.waste_sec += ys["waste"].sum(axis=0, dtype=np.float64) * dt
        self.spot_sec += ys["spot"].sum(axis=0, dtype=np.float64) * dt
        self.drop_cell += ys["drop"].sum(axis=(0, 2), dtype=np.float64)
        self.so += float(np.sum(ys["so"], dtype=np.float64))
        self.si += float(np.sum(ys["si"], dtype=np.float64))
        # util_trace samples at the event loop's cadence (pool-summed);
        # gather all sampled buckets at once — cells are laid out
        # c = model*P + pool, so a [S,M,P,J] reshape groups pools
        s_idx = np.nonzero((b0 + np.arange(S)) % self._sample_b == 1)[0]
        if s_idx.size:
            ts = ((b0 + s_idx) * dt).tolist()
            u = ys["util"][s_idx].reshape(
                s_idx.size, st.M, st.P, st.J).mean(axis=2)
            n = np.rint(ys["inst"][s_idx].reshape(
                s_idx.size, st.M, st.P, st.J).sum(axis=2)).astype(int)
            for mi, m in enumerate(st.models):
                for ji, r in enumerate(st.regions):
                    self.util_trace[(m, r)].extend(
                        zip(ts, u[:, mi, ji].tolist(),
                            n[:, mi, ji].tolist()))
        # per-request latency reconstruction for this segment's window
        lo = int(np.searchsorted(self._rb, b0, side="left"))
        hi = int(np.searchsorted(self._rb, b0 + S, side="left"))
        if hi <= lo:
            return
        sel = slice(lo, hi)
        ok = ~self._rej[sel]
        br = self._rb[sel][ok] - b0
        cell = self._cell[sel][ok]
        ji = self._ji[sel][ok]
        ti = self._ti[sel][ok]
        ttft = (ys["delay"][br, cell, ji].astype(np.float64)
                + self._prompt[sel][ok] / self.st.ptps[cell]
                + np.where(self._is_niw[sel][ok],
                           ys["nw"][br, cell], 0.0))
        e2e = ttft + self._otok[sel][ok] * \
            ys["tbt"][br, cell, ji].astype(np.float64)
        bins_t = np.clip(np.searchsorted(_BINS, ttft) - 1, 0,
                         len(_BINS) - 2)
        bins_e = np.clip(np.searchsorted(_BINS, e2e) - 1, 0,
                         len(_BINS) - 2)
        T = len(self.tiers)
        nb = len(_BINS) - 1
        # bincount beats np.add.at by ~10x on these fills
        self.h_ttft += np.bincount(ti * nb + bins_t,
                                   minlength=T * nb).reshape(T, nb)
        self.h_e2e += np.bincount(ti * nb + bins_e,
                                  minlength=T * nb).reshape(T, nb)
        self.sum_ttft += np.bincount(ti, weights=ttft, minlength=T)
        self.sum_e2e += np.bincount(ti, weights=e2e, minlength=T)
        self.cnt += np.bincount(ti, minlength=T)
        self.slo_bad += np.bincount(ti, weights=(ttft > self.slo[ti]),
                                    minlength=T).astype(np.int64)
        ontime = (self._arr[sel][ok] + e2e) <= self._deadline[sel][ok]
        self.niw_ontime += np.bincount(ti, weights=ontime,
                                       minlength=T).astype(np.int64)

    # -------------------------------------------------------------- finalize
    def finalize(self, cv: Dict[str, np.ndarray],
                 extra_si: float) -> Report:
        st, rp = self.st, self.rp
        T = len(self.tiers)
        # leftovers: still-queued or in-flight work never completed;
        # parked NIW surfaces separately (as the event loop reports it)
        left_cell = (np.asarray(cv["qn"], np.float64).sum(axis=1)
                     + np.asarray(cv["d_n"], np.float64).sum(axis=1))
        parked = float(np.asarray(cv["park_n"], np.float64).sum())
        drops = self.drop_cell + left_cell
        mixn = self.mix / np.maximum(self.mix.sum(axis=1,
                                                  keepdims=True), 1.0)
        drop_tier = (drops[:, None] * mixn).sum(axis=0)
        dropped = {self.tiers[t]: int(self.rej_tier[t]
                                      + round(drop_tier[t]))
                   for t in range(T) if self.n_tier[t]}
        completed = {self.tiers[t]: int(self.n_tier[t])
                     - dropped.get(self.tiers[t], 0)
                     for t in range(T) if self.n_tier[t]}
        ttft, e2e, viol = {}, {}, {}
        for t in range(T):
            if not self.n_tier[t]:
                continue
            name = self.tiers[t]
            c = max(int(self.cnt[t]), 1)
            ttft[name] = {"p50": _percentile(self.h_ttft[t], 0.50),
                          "p75": _percentile(self.h_ttft[t], 0.75),
                          "p95": _percentile(self.h_ttft[t], 0.95),
                          "mean": float(self.sum_ttft[t] / c)}
            e2e[name] = {"p50": _percentile(self.h_e2e[t], 0.50),
                         "p75": _percentile(self.h_e2e[t], 0.75),
                         "p95": _percentile(self.h_e2e[t], 0.95),
                         "mean": float(self.sum_e2e[t] / c)}
            n = float(self.n_tier[t])
            if name == TIER_NIW:
                viol[name] = float(n - self.niw_ontime[t]) / n
            elif np.isfinite(self.slo[t]):
                bad = self.slo_bad[t] + (self.n_tier[t] - self.cnt[t])
                viol[name] = float(bad) / n
            else:
                viol[name] = 0.0
        inst_h: Dict[Key, float] = {}
        waste_h: Dict[Key, float] = {}
        for mi, m in enumerate(st.models):
            for ji, r in enumerate(st.regions):
                cells = [mi * st.P + p for p in range(st.P)]
                inst_h[(m, r)] = float(
                    self.inst_sec[cells, ji].sum() / 3600.0)
                waste_h[(m, r)] = float(
                    self.waste_sec[cells, ji].sum() / 3600.0)
        spot_h = {r: float(self.spot_sec[ji] / 3600.0)
                  for ji, r in enumerate(st.regions)}
        cm = rp.cfg.cost_model or CostModel()
        return Report(
            name=rp.name, ttft=ttft, e2e=e2e, sla_violations=viol,
            completed=completed, dropped=dropped,
            instance_hours=inst_h, wasted_hours=waste_h,
            spot_hours=spot_h,
            scale_out_events=int(round(self.so)),
            scale_in_events=int(round(self.si + extra_si)),
            util_trace=self.util_trace,
            retry_dropped=int(round(float(self.drop_cell.sum()))),
            parked=int(round(parked)),
            gpu_dollars=cm.dollars(inst_h),
            wasted_dollars=cm.dollars(waste_h))
