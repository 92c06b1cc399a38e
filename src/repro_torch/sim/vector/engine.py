"""The vectorized simulation core: a fluid, bucketed fast path.

Port of ``repro.sim.vector.engine``.  State is struct-of-arrays
``[cell, region]`` (cell = model x pool) advanced in fixed ``dt``
buckets; many replicas step in lockstep.  On CUDA a segment of buckets
is ONE launch of the ``bucket_step`` kernel (one block per replica, the
carry in shared memory for the whole segment); on the CPU it is the
kernel's plain version, ``kernels.ref.bucket_segment_ref``, which
rounds every op alike.  The carry of a batch is one packed float32
tensor ``(R, F)`` that stays on the device between segments
(``kernels.ref.BucketLayout`` gives each key's slice).  The Python
control plane (hourly forecast/ILP/placement planners, scenario
outages) is untouched: the segments pause at each control boundary,
the host reads aggregate signals out of the carry in the same shapes
the event loop feeds ``GlobalPlanner.plan``, and the resulting
``Plan`` is applied back into array state before the next segment.

What is fluid here (and therefore approximate — see docs/PERF.md for
the tolerance contract): request flows are real-valued token/count
rates per bucket; per-request queueing delay is reconstructed from the
per-bucket queue-drain estimate the kernel emits.  What is exact:
instance counts and their acquisition delays (spot swap / local load /
remote fetch, as whole buckets), policy trigger logic, hourly plans,
placement actuation, outage windows, and determinism (every reduction
in a fixed order, no atomics: bit-identical across repeats, batch
sizes and batch orders).
"""
from __future__ import annotations

import concurrent.futures
import heapq
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.api.capabilities import capability
from repro_torch.api.plan import Plan, PlacementState
from repro_torch.control.amortize import DEFAULT_CACHE as _SOLVE_CACHE
from repro_torch.control.fleet import FleetForecast
from repro_torch.control.forecast import fit_cache_stats
from repro_torch.kernels import ops
from repro_torch.kernels.ref import DRAIN_RING as _DRAIN_RING
from repro_torch.kernels.ref import BucketLayout
from repro_torch.sim.metrics import Report
from repro_torch.sim.perfmodel import PROFILES, PerfProfile
from repro_torch.sim.simulator import SimConfig
from repro_torch.sim.types import Request
from repro_torch.sim.workload import Trace
from repro_torch.sim.vector.buckets import BucketedTrace, bucketize
from repro_torch.sim.vector.params import (MODE_LT, MODE_REACTIVE, LT_I,
                                           LT_UA, ReplicaParams,
                                           VectorUnsupported, extract,
                                           group_key)
from repro_torch.sim.vector.report import ReplicaAccumulator

#: carry keys the hourly control boundary *reads* (aggregate signals
#: fed to the planner) and the four it *writes* — the batched boundary
#: transfers exactly these slices instead of materializing the carry
_HOUR_READS = ("live", "ring", "dep", "wloc", "warm", "down")
_HOUR_WRITES = ("tgt", "fc", "omega", "has_om")


class _Static:
    """Per-group compile-time constants closed over by the step fn."""

    def __init__(self, models: List[str], regions: List[str],
                 pools: Tuple[str, ...],
                 profiles: Dict[str, PerfProfile], dt: float):
        self.models, self.regions, self.pools = models, regions, pools
        self.M, self.J, self.P = len(models), len(regions), len(pools)
        self.C = self.M * self.P
        self.dt = float(dt)
        per = lambda f: np.asarray([f(profiles[m])
                                    for m in models for _ in pools])
        self.kv = per(lambda p: float(p.kv_capacity_tokens))
        self.ptps = per(lambda p: p.prompt_tps)
        self.tbt0 = per(lambda p: p.base_tbt)
        self.alpha = per(lambda p: p.batch_alpha)
        self.mb = per(lambda p: float(p.max_batch))
        bk = lambda s: np.maximum(np.ceil(s / dt).astype(np.int32), 1)
        self.swap_b = bk(per(lambda p: p.spot_swap_time))
        self.local_b = bk(per(lambda p: p.load_time_local))
        self.remote_b = bk(per(lambda p: p.load_time_remote))
        self.L = int(max(self.swap_b.max(), self.local_b.max(),
                         self.remote_b.max())) + 1
        self.LD = _DRAIN_RING
        # pool->model one-hot (cells of one model share warm tags,
        # weights locality and deployment)
        self.pm = np.zeros((self.M, self.C))
        for mi in range(self.M):
            for p in range(self.P):
                self.pm[mi, mi * self.P + p] = 1.0
        self.cell_model = np.asarray(
            [mi for mi in range(self.M) for _ in pools])
        self.niw_pool = self.P - 1     # NIW lands in the last pool

    # reprolint: cache-key=__init__
    def key(self) -> Tuple:
        """Everything the packed per-cell constants and the layout of
        the step are made of — two groups with equal keys share one
        ``_SEG_CACHE`` entry.  The step reads *counts* and numeric
        arrays, never name strings, so the key holds M/J/P rather than
        the labels: two fleets that differ only in model/region/pool
        names share the entry."""
        # reprolint: key-exempt=models -- names are host-side labels; M is keyed
        # reprolint: key-exempt=regions -- names are host-side labels; J is keyed
        # reprolint: key-exempt=pools -- names are host-side labels; P is keyed
        # reprolint: key-exempt=C -- derived: C = M * P
        # reprolint: key-exempt=L -- derived from swap_b/local_b/remote_b maxima
        # reprolint: key-exempt=LD -- module constant _DRAIN_RING
        # reprolint: key-exempt=pm -- derived one-hot of (M, P)
        # reprolint: key-exempt=cell_model -- derived index map of (M, P)
        # reprolint: key-exempt=niw_pool -- derived: P - 1
        return (self.M, self.J, self.P, self.dt,
                self.kv.tobytes(), self.ptps.tobytes(),
                self.tbt0.tobytes(), self.alpha.tobytes(),
                self.mb.tobytes(), self.swap_b.tobytes(),
                self.local_b.tobytes(), self.remote_b.tobytes())


# (layout, per-cell constants, their device copies) per static config
_SEG_CACHE: Dict[Tuple, Dict] = {}
_SEG_CACHE_STATS = {"hits": 0, "misses": 0}


def seg_cache_stats() -> Dict[str, int]:
    """Uniform cache telemetry (see docs/PERF.md): lifetime hit/miss
    counts for the segment-constants cache.  Unbounded, so evictions is
    always 0 — present for accessor uniformity with SolveCache and the
    forecast fit cache."""
    return {"hits": _SEG_CACHE_STATS["hits"],
            "misses": _SEG_CACHE_STATS["misses"],
            "evictions": 0, "entries": len(_SEG_CACHE)}


def _segments(st: _Static) -> Dict:
    """The packed layout of this static config and its per-cell
    constants (``kernels.ref.BUCKET_CONSTS``, float32), cached
    process-wide so repeat runs and sweep batches sharing a group key
    build them once; ``"on"`` holds a copy per device."""
    key = st.key()
    hit = _SEG_CACHE.get(key)
    if hit is not None:
        _SEG_CACHE_STATS["hits"] += 1
        return hit
    _SEG_CACHE_STATS["misses"] += 1
    lay = BucketLayout(st.M, st.P, st.J, st.L, st.dt)
    consts = np.zeros(lay.NC, np.float32)
    lay.pack_into(consts, {"kv": st.kv, "ptps": st.ptps, "tbt0": st.tbt0,
                           "alpha": st.alpha, "mb": st.mb,
                           "swap_b": st.swap_b, "local_b": st.local_b,
                           "remote_b": st.remote_b},
                  lay.consts_shapes, lay.consts_off)
    _SEG_CACHE[key] = {"layout": lay, "consts": consts, "on": {}}
    return _SEG_CACHE[key]


def _init_carry(st: _Static, rp: ReplicaParams) -> Dict[str, np.ndarray]:
    C, J, M = st.C, st.J, st.M
    z = lambda *s: np.zeros(s, np.float32)
    dep_m = rp.dep0[::st.P].astype(np.float32)
    return {"live": rp.live0.astype(np.float32), "f_tok": z(C, J),
            "qp": z(C, J), "qo": z(C, J), "qn": z(C, J),
            "d_o": z(C, J), "d_n": z(C, J),
            "ring": z(st.L, C, J), "drainq": z(st.LD, C, J),
            "spot": np.full(J, rp.spot_spare, np.float32),
            "warm": z(M, J), "wloc": dep_m.copy(), "cd": z(C, J),
            "tgt": np.full((C, J), -1.0, np.float32), "fc": z(C, J),
            "dep": dep_m, "down": z(J), "dead": z(C),
            "park_p": z(C, J), "park_o": z(C, J), "park_n": z(C, J),
            "relcum": z(C),
            "omega": z(C, J, J), "has_om": z(C, J)}


def _prm(st: _Static, rp: ReplicaParams) -> Dict[str, np.ndarray]:
    dt = st.dt
    s = lambda v: np.float32(v)
    caps = np.where(np.isinf(rp.region_caps), 1e9,
                    rp.region_caps).astype(np.float32)
    return {"mode": np.int32(rp.mode),
            "lt_i": s(1.0 if (rp.mode == MODE_LT and
                              rp.lt_variant == LT_I) else 0.0),
            "lt_ua": s(1.0 if (rp.mode == MODE_LT and
                               rp.lt_variant == LT_UA) else 0.0),
            "up": s(rp.up), "down": s(rp.down),
            "cd_b": s(max(round(rp.cooldown_s / dt), 1)),
            "min_inst": s(rp.min_inst),
            "ua_hi": s(rp.ua_hi), "ua_lo": s(rp.ua_lo),
            "ua_win_b": s(rp.ua_window_s / dt),
            "hour_b": s(max(rp.hour_s / dt, 1.0)),
            "route_thr": s(rp.route_thr),
            "plan_router": s(1.0 if rp.plan_router else 0.0),
            "has_qm": s(1.0 if rp.has_qm else 0.0),
            "qm_sig": s(rp.qm_sig), "qm_one": s(rp.qm_one),
            "qm_two": s(rp.qm_two), "qm_age": s(rp.qm_promote_age),
            "chiron_theta": s(rp.chiron_theta),
            "chiron_mixed": s(rp.chiron_mixed),
            "chiron_prof": rp.chiron_prof.astype(np.float32),
            "drop_budget_b": s(rp.drop_budget_s / dt),
            "caps": caps}


class VectorBatch:
    """Run one *group* of replicas (same models/regions/pools/profiles/
    tick — see ``params.group_key``) in lockstep over one trace.

    ``batched=True`` steps all replicas in one batch (one block each);
    ``batched=False`` runs them one after the other, each in a batch of
    its own (the parity baseline for the batch-of-1 test).  ``device``:
    where the segments step and the fleet's forecasts fit, CUDA unless
    ``"cpu"`` (raises when CUDA is asked for and absent)."""

    def __init__(self, trace: Union[Trace, Sequence[Request]],
                 cfgs: Sequence[SimConfig],
                 names: Optional[Sequence[str]] = None,
                 models: Optional[List[str]] = None,
                 regions: Optional[List[str]] = None,
                 profiles: Optional[Dict[str, PerfProfile]] = None,
                 batched: bool = True,
                 control_workers: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if not isinstance(trace, Trace):
            trace = Trace.from_requests(trace)
        self.trace = trace.sorted_by_arrival()
        self.models = models or list(self.trace.models)
        self.regions = regions or list(self.trace.regions)
        self.profiles = profiles or {m: PROFILES[m] for m in self.models}
        names = names or [f"sim{i}" for i in range(len(cfgs))]
        self.rps = [extract(cfg, self.models, self.regions,
                            self.profiles, name)
                    for cfg, name in zip(cfgs, names)]
        keys = {group_key(rp, tuple(self.models), tuple(self.regions),
                          self.profiles) for rp in self.rps}
        if len(keys) > 1:
            raise VectorUnsupported(
                "replicas in one VectorBatch must share a group key "
                "(models/regions/pools/profiles/tick); got "
                f"{len(keys)} distinct keys")
        cfg0 = self.rps[0].cfg
        if cfg0.siloed and any(rp.mode != MODE_REACTIVE
                               for rp in self.rps):
            raise VectorUnsupported(
                "siloed pools with a non-reactive scaler have no "
                "vector lowering (LT/Chiron act on the unified pool)")
        self.batched = batched
        # plan solves run on a small thread pool (scipy/HiGHS releases
        # the GIL); results are collected in replica order, so the
        # emitted plans are identical for any worker count
        if control_workers is None:
            control_workers = int(os.environ.get(
                "REPRO_CONTROL_WORKERS",
                max(1, min(8, os.cpu_count() or 1))))
        self.control_workers = max(1, control_workers)
        #: per-boundary control-plane timing/dedupe totals, filled by
        #: ``run()`` — see docs/PERF.md "control plane at sweep scale"
        self.control_stats: Dict[str, float] = {}
        self.st = _Static(self.models, self.regions, self.rps[0].pools,
                          self.profiles, cfg0.tick)
        # segment-cache activity happens here (construction), so run()
        # reports deltas against this snapshot
        self._seg_stats0 = seg_cache_stats()
        seg = _segments(self.st)
        self.layout = seg["layout"]
        dkey = str(self.device)
        if dkey not in seg["on"]:
            seg["on"][dkey] = torch.from_numpy(seg["consts"]).to(self.device)
        self._consts = seg["on"][dkey]

    # ------------------------------------------------------------ plumbing
    def _expand(self, arr_mj: np.ndarray, pool: int) -> np.ndarray:
        """[B, M, J] model flow -> [B, C, J] with mass in one pool."""
        st = self.st
        B = arr_mj.shape[0]
        out = np.zeros((B, st.C, st.J), np.float32)
        for mi in range(st.M):
            out[:, mi * st.P + pool, :] = arr_mj[:, mi, :]
        return out

    def _build_xs(self, bk: BucketedTrace) -> Dict[str, np.ndarray]:
        st = self.st
        iw, niw = 0, st.niw_pool
        xs = {"iw_n": self._expand(bk.iw_n, iw),
              "iw_p": self._expand(bk.iw_p, iw),
              "iw_o": self._expand(bk.iw_o, iw),
              "niw_n": self._expand(bk.niw_n, niw),
              "niw_p": self._expand(bk.niw_p, niw),
              "niw_o": self._expand(bk.niw_o, niw)}
        obs = np.zeros((bk.n_buckets, st.C, st.J), np.float32)
        for mi in range(st.M):
            for p in range(st.P):
                obs[:, mi * st.P + p, :] = bk.obs_tps[:, mi, :]
        xs["obs"] = obs
        fcum = np.zeros((bk.n_buckets, st.C), np.float32)
        rp0 = self.rps[0]
        if rp0.has_qm:
            fm = bk.force_release_cum(rp0.qm_promote_age, rp0.qm_slack)
            for mi in range(st.M):
                fcum[:, mi * st.P + niw] = fm[:, mi]
        xs["fcum"] = fcum
        xs["b"] = np.arange(bk.n_buckets, dtype=np.int32)
        return xs

    # ------------------------------------------------------------ boundaries
    def _schedule(self, horizon: float) -> List[Tuple[int, int, str, int,
                                                      object]]:
        """Initial boundary heap: (bucket, seq, kind, replica, payload)."""
        dt = self.st.dt
        ev: List[Tuple[int, int, str, int, object]] = []
        seq = 0
        if any(rp.controller is not None for rp in self.rps):
            t = 3600.0
            while t < horizon:
                ev.append((int(round(t / dt)), seq, "hour", -1, None))
                seq += 1
                t += 3600.0
        for i, rp in enumerate(self.rps):
            sc = rp.scenario
            for o in (getattr(sc, "outages", ()) or ()):
                if o.region not in self.regions:
                    continue
                j = self.regions.index(o.region)
                ev.append((int(round(o.start / dt)), seq, "down", i, j))
                seq += 1
                ev.append((int(round(o.end / dt)), seq, "up", i, j))
                seq += 1
        heapq.heapify(ev)
        self._seq = seq
        return ev

    def _instances(self, cv: Dict[str, np.ndarray]
                   ) -> Dict[Tuple[str, str], int]:
        st = self.st
        live, ring = cv["live"], cv["ring"]
        pend = ring.sum(axis=0)
        instances: Dict[Tuple[str, str], int] = {}
        for mi, m in enumerate(st.models):
            for ji, r in enumerate(st.regions):
                n = sum(live[mi * st.P + p, ji] + pend[mi * st.P + p, ji]
                        for p in range(st.P))
                instances[(m, r)] = int(round(n))
        return instances

    def _feed_placement(self, rep_i: int,
                        cv: Dict[str, np.ndarray]) -> None:
        st, rp = self.st, self.rps[rep_i]
        feed = capability(rp.controller, "set_placement_state")
        if feed is None:
            return
        placed = frozenset((m, r) for mi, m in enumerate(st.models)
                           for ji, r in enumerate(st.regions)
                           if cv["dep"][mi, ji] > 0.5)
        wl = frozenset((m, r) for mi, m in enumerate(st.models)
                       for ji, r in enumerate(st.regions)
                       if cv["wloc"][mi, ji] > 0.5)
        ws = {(m, r): int(cv["warm"][mi, ji])
              for mi, m in enumerate(st.models)
              for ji, r in enumerate(st.regions)
              if cv["warm"][mi, ji] >= 1.0}
        dn = frozenset(r for ji, r in enumerate(st.regions)
                       if cv["down"][ji] > 0.5)
        feed(PlacementState(placed=placed, weights_local=wl,
                            warm_spot=ws, down_regions=dn))

    def _lookback(self, rep_i: int) -> float:
        cfg = self.rps[rep_i].cfg
        return max(cfg.history_lookback, 3600.0 + 2 * cfg.tps_window)

    def _apply_hour(self, rep_i: int, cv: Dict[str, np.ndarray],
                    t: float, bk: BucketedTrace,
                    heap: List) -> None:
        """Serial reference path: one replica's full hourly round —
        signal extraction, its own forecast, solve, apply."""
        rp = self.rps[rep_i]
        if rp.controller is None:
            return
        instances = self._instances(cv)
        self._feed_placement(rep_i, cv)
        plan = rp.controller.plan(t, instances,
                                  bk.planner_series(t, self._lookback(rep_i)),
                                  bk.niw_last_hour(t))
        self._apply_plan(rep_i, cv, t, plan, heap)

    def _apply_plan(self, rep_i: int, cv: Dict[str, np.ndarray],
                    t: float, plan, heap: List) -> None:
        """Write one replica's hourly plan into array state: stage or
        actuate placement actions, overwrite targets/forecasts/ω."""
        st, rp = self.st, self.rps[rep_i]
        if isinstance(plan, tuple):
            targets, forecasts = plan
            plan = Plan(t=t, targets=targets, forecasts=forecasts)
        if plan.placement is not None:
            for a in plan.placement.actions:
                bkt = int(round(a.effective_at / st.dt))
                if a.effective_at <= t:
                    self._apply_place(rep_i, cv, a, int(round(t / st.dt)))
                else:
                    heapq.heappush(heap, (bkt, self._seq, "place",
                                          rep_i, a))
                    self._seq += 1
        cv["tgt"][:] = -1.0
        cv["fc"][:] = 0.0
        for (m, r), v in plan.targets.items():
            if m in st.models and r in st.regions:
                mi, ji = st.models.index(m), st.regions.index(r)
                cv["tgt"][mi * st.P, ji] = float(v)
                cv["fc"][mi * st.P, ji] = float(
                    plan.forecasts.get((m, r), 0.0))
        cv["omega"][:] = 0.0
        cv["has_om"][:] = 0.0
        if rp.plan_router and plan.routing is not None:
            for (m, h), fr in plan.routing.fractions.items():
                if m not in st.models or h not in st.regions:
                    continue
                mi, hj = st.models.index(m), st.regions.index(h)
                row = np.asarray([max(fr.get(r, 0.0), 0.0)
                                  for r in st.regions])
                tot = row.sum()
                if tot <= 0.0:
                    continue
                for p in range(st.P):
                    cv["omega"][mi * st.P + p, hj, :] = row / tot
                    cv["has_om"][mi * st.P + p, hj] = 1.0

    def _apply_down(self, rep_i: int, cv: Dict[str, np.ndarray],
                    j: int) -> None:
        st = self.st
        cv["down"][j] = 1.0
        freed = cv["live"][:, j].copy()
        cv["live"][:, j] = 0.0
        pend = cv["ring"][:, :, j].sum(axis=0)
        drn = cv["drainq"][:, :, j].sum(axis=0)
        cv["spot"][j] += freed.sum() + pend.sum() + drn.sum()
        cv["warm"][:, j] += st.pm @ (freed + pend + drn)
        cv["ring"][:, :, j] = 0.0
        cv["drainq"][:, :, j] = 0.0
        # queued + in-flight work re-routes to the most-alive region
        for c in range(st.C):
            others = [k for k in range(st.J) if k != j]
            k = max(others, key=lambda kk: cv["live"][c, kk])
            cv["qn"][c, k] += cv["qn"][c, j] + cv["d_n"][c, j]
            cv["qp"][c, k] += cv["qp"][c, j]
            cv["qo"][c, k] += cv["qo"][c, j] + cv["d_o"][c, j]
            cv["f_tok"][c, k] += cv["f_tok"][c, j]
        for key in ("qn", "qp", "qo", "d_n", "d_o", "f_tok"):
            cv[key][:, j] = 0.0

    def _apply_place(self, rep_i: int, cv: Dict[str, np.ndarray],
                     act, b0: int) -> None:
        st = self.st
        if act.model not in st.models or act.region not in st.regions:
            return
        mi, ji = st.models.index(act.model), st.regions.index(act.region)
        if act.deploy:
            cv["dep"][mi, ji] = 1.0
            cv["wloc"][mi, ji] = 1.0
            return
        cv["dep"][mi, ji] = 0.0
        for p in range(st.P):
            c = mi * st.P + p
            n = cv["live"][c, ji]
            cv["live"][c, ji] = 0.0
            cv["drainq"][(b0 + st.LD - 1) % st.LD, c, ji] += n
            self._extra_si[rep_i] += n
            pend = cv["ring"][:, c, ji].sum()
            cv["spot"][ji] += pend
            cv["warm"][mi, ji] += pend
            cv["ring"][:, c, ji] = 0.0

    # ------------------------------------------------------ packed carry
    def _pack(self, tree: Dict[str, np.ndarray], shapes, offsets,
              width: int) -> torch.Tensor:
        """One replica's dict -> a (1, width) float32 tensor on the
        batch's device."""
        flat = np.zeros((1, width), np.float32)
        BucketLayout.pack_into(flat, {k: np.asarray(tree[k], np.float32)
                                      for k in shapes}, shapes, offsets)
        return torch.from_numpy(flat).to(self.device)

    def _host(self, carry: torch.Tensor) -> np.ndarray:
        """A writable host copy of a packed carry."""
        return carry.cpu().numpy().copy()

    def _views(self, host: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """Each replica's carry dict: views that write ``host``."""
        return [self.layout.carry(host[i]) for i in range(host.shape[0])]

    def _columns(self, names: Tuple[str, ...]) -> torch.Tensor:
        """The packed carry's columns of these keys, in their order."""
        lay = self.layout
        return torch.cat([torch.arange(
            lay.carry_off[k], lay.carry_off[k] + int(np.prod(
                lay.carry_shapes[k], dtype=np.int64)))
            for k in names]).to(self.device)

    def _segment(self, prm: torch.Tensor, carry: torch.Tensor,
                 xs: torch.Tensor, b0: int, b1: int):
        """One segment, b0..b1-1, for the replicas of ``carry``: the
        kernel on CUDA, its plain version on the CPU.  Returns the new
        carry and the host ys (R, b1 - b0, Y)."""
        out, ys = ops.bucket_segment(self.layout, self._consts, prm, carry,
                                     xs[b0:b1], b0, b1)
        return out, ys.cpu().numpy()

    # --------------------------------------------------- batched boundaries
    def _hour_round_batched(self, carry: torch.Tensor, t: float,
                            bk: BucketedTrace, heap: List) -> torch.Tensor:
        """One hourly boundary for the whole batch: copy to the host
        only the aggregate-signal slices the planners read, run ONE
        fleet-wide stacked forecast, solve the per-replica ILPs on a
        thread pool (plans collected in replica order — identical for
        any worker count), then write the four plan keys back.  The
        rest of the carry stays on the device.  Returns the updated
        carry (fully host-materialized only if a plan actuates a
        placement *now*, which touches far more than the plan slice)."""
        cs = self.control_stats
        ctrl = [i for i, rp in enumerate(self.rps)
                if rp.controller is not None]
        if not ctrl:
            return carry
        cs["boundaries"] += 1
        lay = self.layout
        t0 = time.perf_counter()
        names = _HOUR_READS + _HOUR_WRITES
        part = carry.index_select(1, self._columns(names)).cpu().numpy()
        shapes = {k: lay.carry_shapes[k] for k in names}
        pulled = BucketLayout.unpack(part, shapes,
                                     BucketLayout._offsets(shapes)[0])
        cs["transfer_s"] += time.perf_counter() - t0
        cvs = {i: {k: pulled[k][i] for k in pulled} for i in ctrl}
        insts = {}
        for i in ctrl:
            self._feed_placement(i, cvs[i])
            insts[i] = self._instances(cvs[i])
        # histories come from the shared bucketized trace (host side)
        # and are identical across replicas with equal lookbacks:
        # build each distinct dict once
        t0 = time.perf_counter()
        hist_by_lb: Dict[float, Dict] = {}
        hists = {}
        for i in ctrl:
            lb = self._lookback(i)
            if lb not in hist_by_lb:
                hist_by_lb[lb] = bk.planner_series(t, lb)
            hists[i] = hist_by_lb[lb]
        niw = bk.niw_last_hour(t)
        fitted = self._fleet.fit({str(i): hists[i] for i in ctrl
                                  if self._fleet.batched(str(i))})
        cs["forecast_s"] += time.perf_counter() - t0

        def solve_one(i):
            rp = self.rps[i]
            fit = fitted.get(str(i))
            if fit is not None:
                fn = capability(rp.controller, "plan_fitted")
                return fn(t, insts[i], hists[i], niw, fit)
            return rp.controller.plan(t, insts[i], hists[i], niw)

        t0 = time.perf_counter()
        if self._pool is not None and len(ctrl) > 1:
            plans = list(self._pool.map(solve_one, ctrl))
        else:
            plans = [solve_one(i) for i in ctrl]
        cs["ilp_s"] += time.perf_counter() - t0
        cs["plans"] += len(plans)

        t0 = time.perf_counter()
        immediate = any(
            getattr(p, "placement", None) is not None and
            any(a.effective_at <= t for a in p.placement.actions)
            for p in plans)
        if immediate:
            host = self._host(carry)
            cvs_all = self._views(host)
            for i, plan in zip(ctrl, plans):
                self._apply_plan(i, cvs_all[i], t, plan, heap)
            carry = torch.from_numpy(host).to(self.device)
        else:
            for i, plan in zip(ctrl, plans):
                self._apply_plan(i, cvs[i], t, plan, heap)
            # mutated through the cvs views
            carry = carry.clone()
            carry[:, self._columns(_HOUR_WRITES)] = torch.from_numpy(
                np.concatenate([pulled[k].reshape(len(self.rps), -1)
                                for k in _HOUR_WRITES], axis=1)
            ).to(self.device)
        cs["apply_s"] += time.perf_counter() - t0
        return carry

    # ------------------------------------------------------------ main loop
    def run(self) -> List[Report]:
        st, lay = self.st, self.layout
        cfg0 = self.rps[0].cfg
        tr = self.trace
        last_arrival = float(tr.arrival[-1]) if len(tr) else 0.0
        horizon = last_arrival + cfg0.drain_grace
        kv_caps = {m: self.profiles[m].kv_capacity_tokens
                   for m in st.models}
        bk = bucketize(tr, st.dt, horizon, kv_caps,
                       hist_window=cfg0.tps_window)
        xs_full = self._build_xs(bk)
        B = bk.n_buckets
        R = len(self.rps)
        self._extra_si = [0.0] * R
        accs = [ReplicaAccumulator(rp, st, bk) for rp in self.rps]
        heap = self._schedule(horizon)
        xs = np.zeros((B, lay.X), np.float32)
        BucketLayout.pack_into(xs, {k: xs_full[k] for k in lay.xs_shapes},
                               lay.xs_shapes, lay.xs_off)
        xs = torch.from_numpy(xs).to(self.device)
        prms = [self._pack(_prm(st, rp), lay.prm_shapes, lay.prm_off, lay.K)
                for rp in self.rps]
        carries = [self._pack(_init_carry(st, rp), lay.carry_shapes,
                              lay.carry_off, lay.F) for rp in self.rps]
        self.control_stats = {"boundaries": 0, "plans": 0,
                              "forecast_s": 0.0, "ilp_s": 0.0,
                              "transfer_s": 0.0, "apply_s": 0.0}
        ctrl_ids = [i for i, rp in enumerate(self.rps)
                    if rp.controller is not None]
        self._fleet = FleetForecast(
            {str(i): self.rps[i].controller for i in ctrl_ids},
            device=self.device) if (self.batched and ctrl_ids) else None
        self._pool = None
        if (self.batched and self.control_workers > 1
                and len(ctrl_ids) > 1):
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.control_workers)
        sc0 = _SOLVE_CACHE.cache_stats()
        fc0 = fit_cache_stats()
        if self.batched:
            prm = torch.cat(prms)
            carry = torch.cat(carries)
        try:
            b0 = 0
            while b0 < B:
                events = []
                while heap and heap[0][0] <= b0:
                    events.append(heapq.heappop(heap))
                if events:
                    t = b0 * st.dt
                    if self.batched and all(
                            e[2] == "hour" and e[3] < 0 for e in events):
                        for _ in events:
                            carry = self._hour_round_batched(
                                carry, t, bk, heap)
                    else:
                        # mixed or per-replica events (outage down/up,
                        # staged placements): materialize and use the
                        # serial per-event path
                        if self.batched:
                            host = self._host(carry)
                            cvs = self._views(host)
                        else:
                            hosts = [self._host(c) for c in carries]
                            cvs = [self._views(h)[0] for h in hosts]
                        for _, _, kind, ri, payload in events:
                            for i in (range(R) if ri < 0 else (ri,)):
                                cv = cvs[i]
                                if kind == "hour":
                                    self._apply_hour(i, cv, t, bk, heap)
                                elif kind == "down":
                                    self._apply_down(i, cv, payload)
                                elif kind == "up":
                                    cv["down"][payload] = 0.0
                                elif kind == "place":
                                    self._apply_place(i, cv, payload, b0)
                        if self.batched:
                            carry = torch.from_numpy(host).to(self.device)
                        else:
                            carries = [torch.from_numpy(h).to(self.device)
                                       for h in hosts]
                b1 = min(heap[0][0] if heap else B, B)
                b1 = max(b1, b0 + 1)
                if self.batched:
                    # the carry stays on the device between segments;
                    # only boundary slices are ever transferred
                    carry, ys = self._segment(prm, carry, xs, b0, b1)
                    for i, acc in enumerate(accs):
                        acc.ingest(b0, lay.ys(ys[i]))
                else:
                    for i, acc in enumerate(accs):
                        carries[i], ys = self._segment(
                            prms[i], carries[i], xs, b0, b1)
                        acc.ingest(b0, lay.ys(ys[0]))
                b0 = b1
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
        if self._fleet is not None:
            for k, v in self._fleet.stats().items():
                self.control_stats[f"fleet_{k}"] = v
        # cache-fragmentation telemetry: per-run deltas of every
        # control-plane cache
        sc1 = _SOLVE_CACHE.cache_stats()
        fc1 = fit_cache_stats()
        sg1, sg0 = seg_cache_stats(), self._seg_stats0
        for k in ("hits", "misses", "evictions"):
            self.control_stats[f"ilp_cache_{k}"] = sc1[k] - sc0[k]
            self.control_stats[f"fit_cache_{k}"] = fc1[k] - fc0[k]
        self.control_stats["seg_cache_hits"] = sg1["hits"] - sg0["hits"]
        self.control_stats["seg_cache_misses"] = \
            sg1["misses"] - sg0["misses"]
        if self.batched:
            cvs = self._views(self._host(carry))
        else:
            cvs = [self._views(self._host(c))[0] for c in carries]
        return [acc.finalize(cvs[i], self._extra_si[i])
                for i, acc in enumerate(accs)]


class VectorSimulation:
    """Drop-in single-replica front end: same constructor shape as
    ``repro_torch.sim.simulator.Simulation``, runs on the vector core."""

    def __init__(self, requests: Union[Trace, Sequence[Request]],
                 cfg: SimConfig, models: Optional[List[str]] = None,
                 regions: Optional[List[str]] = None,
                 profiles: Optional[Dict[str, PerfProfile]] = None,
                 name: str = "sim", device: DeviceLike = None):
        self._batch = VectorBatch(requests, [cfg], names=[name],
                                  models=models, regions=regions,
                                  profiles=profiles, batched=False,
                                  device=device)

    def run(self) -> Report:
        return self._batch.run()[0]
