"""Extraction of per-replica control parameters into plain arrays.

The vector core cannot call ``Scaler.on_tick`` per bucket — the whole
point is that the inner loop is one kernel launch per segment — so the
*known* policy classes (Reactive, LT-I/U/UA, Chiron) are compiled down to
numeric parameters interpreted branch-free inside the kernel.  Anything the
kernel cannot faithfully express raises ``VectorUnsupported`` so the
caller can fall back to the event loop instead of silently running
different semantics.  Hourly planners/controllers are *not* extracted:
they stay live Python objects, called at control boundaries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.capabilities import capability
from repro_torch.core.chiron import ChironPolicy
from repro_torch.core.queue_manager import QueueManager
from repro_torch.core.scaling import LTPolicy, ReactivePolicy
from repro_torch.sim.perfmodel import PerfProfile
from repro_torch.sim.simulator import SimConfig

MODE_REACTIVE, MODE_LT, MODE_CHIRON = 0, 1, 2
LT_I, LT_U, LT_UA = 0, 1, 2


class VectorUnsupported(RuntimeError):
    """The stack uses a component the vector kernel cannot express;
    run it on the event loop instead."""


def _retry_budget(cfg: SimConfig) -> float:
    """Total seconds a request retries against a dead endpoint before
    the event loop drops it."""
    return sum(min(cfg.retry_base * 2.0 ** k, cfg.retry_cap)
               for k in range(cfg.max_retries))


@dataclasses.dataclass
class ReplicaParams:
    """Scalar/array policy knobs for one replica, kernel-ready.

    Per-cell arrays are indexed ``c = model_idx * P + pool_idx`` with
    pools ``("unified",)`` or ``("IW", "NIW")``.
    """

    name: str
    cfg: SimConfig
    pools: Tuple[str, ...]
    # scaler
    mode: int
    lt_variant: int
    up: float
    down: float
    cooldown_s: float
    min_inst: float
    ua_hi: float
    ua_lo: float
    ua_window_s: float
    hour_s: float
    chiron_theta: float
    chiron_mixed: float
    chiron_prof: np.ndarray          # [C] profiled TPS per cell
    # router
    route_thr: float
    plan_router: bool
    # queue manager
    has_qm: bool
    qm_sig: float
    qm_one: float
    qm_two: float
    qm_promote_age: float
    qm_slack: float
    # retry/drop budget
    drop_budget_s: float
    # initial state
    live0: np.ndarray                # [C, J]
    dep0: np.ndarray                 # [C, J] deployed mask
    region_caps: np.ndarray          # [J]
    spot_spare: float
    # live python control plane (boundary-time only)
    controller: Optional[object]
    scenario: Optional[object]


def extract(cfg: SimConfig, models: List[str], regions: List[str],
            profiles: Dict[str, PerfProfile], name: str = "sim"
            ) -> ReplicaParams:
    """Compile a ``SimConfig`` into kernel parameters, or raise
    ``VectorUnsupported``."""
    pools = ("IW", "NIW") if cfg.siloed else ("unified",)
    P, M, J = len(pools), len(models), len(regions)
    C = M * P

    pol = cfg.policy
    mode, lt_variant = MODE_REACTIVE, LT_UA
    up = down = 0.0
    cooldown_s = 15.0
    min_inst = 2.0
    ua_hi = ua_lo = 0.0
    ua_window_s = 1200.0
    hour_s = 3600.0
    chiron_theta = 0.6
    chiron_mixed = 0.0
    chiron_prof = np.full(C, 1000.0)
    if isinstance(pol, ChironPolicy):
        mode = MODE_CHIRON
        cooldown_s = pol.cooldown
        min_inst = float(pol.min_instances)
        chiron_theta = pol.theta
        chiron_mixed = float(pol.init[1])
        chiron_prof = np.asarray(
            [pol.profile_tps.get(m, 1000.0)
             for m in models for _ in pools])
    elif isinstance(pol, LTPolicy):
        mode = MODE_LT
        lt_variant = {"I": LT_I, "U": LT_U, "UA": LT_UA}[pol.mode]
        up, down = pol.up, pol.down
        cooldown_s = pol.cooldown
        min_inst = float(pol.min_instances)
        ua_hi, ua_lo = pol.ua_hi, pol.ua_lo
        ua_window_s, hour_s = pol.ua_window, pol.hour
    elif isinstance(pol, ReactivePolicy):
        up, down = pol.up, pol.down
        cooldown_s = pol.cooldown
        min_inst = float(pol.min_instances)
    else:
        raise VectorUnsupported(
            f"scaler {type(pol).__name__} has no vector lowering")

    router = cfg.router
    plan_router = False
    route_thr = cfg.route_threshold
    if router is not None:
        if capability(router, "route_request") is not None:
            if capability(router, "update_plan") is None:
                raise VectorUnsupported(
                    f"router {type(router).__name__}: per-request "
                    f"routing without a plan feed has no vector lowering")
            plan_router = True
            route_thr = getattr(router, "threshold", cfg.route_threshold)
        else:
            thr = capability(router, "home_threshold")
            if thr is None:
                raise VectorUnsupported(
                    f"router {type(router).__name__} has no vector "
                    f"lowering (needs home_threshold or route_request)")
            route_thr = float(thr())

    qm = cfg.queue_manager
    has_qm = qm is not None
    if has_qm and not isinstance(qm, QueueManager):
        raise VectorUnsupported(
            f"queue manager {type(qm).__name__} has no vector lowering")
    qm_one = qm.one_thresh if has_qm else 0.6
    qm_two = qm.two_thresh if has_qm else 0.5
    qm_age = qm.promote_age if has_qm else 10 * 3600.0
    qm_slack = qm.deadline_slack if has_qm else 2 * 3600.0

    placement = cfg.placement
    dep0 = np.ones((C, J))
    if placement is not None:
        for mi, m in enumerate(models):
            allowed = set(placement.get(m, ()))
            for ji, r in enumerate(regions):
                if r not in allowed:
                    for p in range(P):
                        dep0[mi * P + p, ji] = 0.0

    per_pool = ({"IW": cfg.siloed_iw, "NIW": cfg.siloed_niw}
                if cfg.siloed else {"unified": cfg.initial_instances})
    live0 = np.zeros((C, J))
    for mi in range(M):
        for pi, pool in enumerate(pools):
            live0[mi * P + pi] = per_pool[pool] * dep0[mi * P + pi]

    caps = np.full(J, math.inf)
    scenario = cfg.scenario
    if scenario is not None and getattr(scenario, "region_caps", None):
        for ji, r in enumerate(regions):
            if r in scenario.region_caps:
                caps[ji] = float(scenario.region_caps[r])

    return ReplicaParams(
        name=name, cfg=cfg, pools=pools,
        mode=mode, lt_variant=lt_variant, up=up, down=down,
        cooldown_s=cooldown_s, min_inst=min_inst,
        ua_hi=ua_hi, ua_lo=ua_lo, ua_window_s=ua_window_s, hour_s=hour_s,
        chiron_theta=chiron_theta, chiron_mixed=chiron_mixed,
        chiron_prof=chiron_prof,
        route_thr=route_thr, plan_router=plan_router,
        has_qm=has_qm, qm_sig=cfg.qm_signal_thresh, qm_one=qm_one,
        qm_two=qm_two, qm_promote_age=qm_age, qm_slack=qm_slack,
        drop_budget_s=_retry_budget(cfg),
        live0=live0, dep0=dep0, region_caps=caps,
        spot_spare=float(cfg.spot_spare),
        controller=cfg.controller, scenario=scenario)


def group_key(rp: ReplicaParams, models: Tuple[str, ...],
              regions: Tuple[str, ...],
              profiles: Dict[str, PerfProfile]) -> Tuple:
    """Replicas sharing this key can step in one batch: same
    array shapes, same bucketing, same per-cell service rates."""
    prof_sig = tuple(
        (m, profiles[m].prompt_tps, profiles[m].base_tbt,
         profiles[m].batch_alpha, profiles[m].max_batch,
         profiles[m].kv_capacity_tokens, profiles[m].load_time_local,
         profiles[m].load_time_remote, profiles[m].spot_swap_time)
        for m in models)
    cfg = rp.cfg
    return (models, regions, rp.pools, prof_sig, cfg.tick,
            cfg.drain_grace, cfg.tps_window,
            rp.qm_promote_age if rp.has_qm else None,
            rp.qm_slack if rp.has_qm else None)
