"""Discrete-event simulator: the paper's evaluation harness (§7.1),
extending the SplitWise instance model to regions, endpoints, routing,
the NIW queue manager, reactive/predictive scaling and the hourly
forecast+ILP controller.

The core is an event-hook loop: typed events (``Arrival``,
``PrefillDone``, ``Tick``, ``Hour``, ...) are popped off a heap and
published on a ``HookBus``; cluster mechanics and policy adapters are
subscribers.  Policies are protocol-typed (``repro_torch.api.protocols``) and
see the cluster only through ``EndpointView``s and ``Signal``s — the
simulator never special-cases a concrete policy class.  Stacks are
normally assembled declaratively via ``repro_torch.api.build_stack``;
``SimConfig`` remains the low-level wiring record it produces.

Hot-path design (see docs/PERF.md): arrivals are fed from a sorted
cursor instead of pre-heaped (10M heap entries would dominate memory and
log-factor cost), endpoint load queries are O(1) incremental aggregates
(``repro_torch.sim.cluster.Endpoint``), TPS accounting is a bounded ring
buffer (``repro_torch.sim.tps.TpsHistory``), and the drain check keeps an
in-flight work-event counter instead of scanning the heap.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import defaultdict
from collections.abc import Mapping
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.api.capabilities import capability
from repro_torch.api.plan import Plan
from repro_torch.api.registry import resolve
from repro_torch.api.signals import BacklogSignal
from repro_torch.core.scaling import EndpointView, ScaleAction, ScalingPolicy
from repro_torch.sim.cluster import Cluster, PendingInstance
from repro_torch.sim.events import (CONTROL_EVENT_SET, Arrival, DecodeDone,
                              Event, HookBus, Hour, InstanceReady,
                              OutageEnd, OutageStart, PlacementEffective,
                              PrefillDone, Retry, Tick)
from repro_torch.sim.instance import Instance
from repro_torch.sim.metrics import Report, build_report
from repro_torch.sim.perfmodel import PROFILES, PerfProfile
from repro_torch.sim.tps import TpsHistory
from repro_torch.sim.types import Request, TIER_NIW

Key = Tuple[str, str]


class _RegionUtils(Mapping):
    """Live, lazy per-region utilization view handed to per-request
    routers: utilization is computed only for the regions the router
    actually inspects, so a plan hit touches one endpoint instead of
    building the full utils dict per arrival (the fallback paths that
    iterate or ``dict()`` it still see every region)."""

    __slots__ = ("_eps", "_regions")

    def __init__(self, eps: Dict[str, object], regions: Sequence[str]):
        self._eps = eps
        self._regions = regions

    def __getitem__(self, region: str) -> float:
        return self._eps[region].util

    def __iter__(self):
        return iter(self._regions)

    def __len__(self) -> int:
        return len(self._regions)


@dataclasses.dataclass
class SimConfig:
    policy: object                        # Scaler protocol
    scheduler: Union[str, Callable] = "fcfs"   # Scheduler name or callable
    controller: Optional[object] = None   # GlobalPlanner protocol
    queue_manager: Optional[object] = None  # QueuePolicy protocol
    router: Optional[object] = None       # Router protocol; None → threshold
    siloed: bool = False                  # separate IW/NIW pools
    initial_instances: int = 20           # per (model, region) total
    siloed_iw: int = 16
    siloed_niw: int = 4
    spot_spare: int = 10
    tick: float = 15.0
    sample_every: float = 60.0
    route_threshold: float = 0.7
    qm_signal_thresh: float = 0.6
    tps_window: float = 60.0
    drain_grace: float = 6 * 3600.0       # sim horizon past last arrival
    # retry/backoff when an endpoint has zero live instances: attempt k
    # waits min(retry_base * 2**(k-1), retry_cap); past max_retries the
    # request is dropped and surfaced in the Report.
    retry_base: float = 5.0
    retry_cap: float = 160.0
    max_retries: int = 12
    # TTFT SLO per tier for violation accounting; None → paper defaults
    # (repro_torch.sim.types.TTFT_SLA).  Request deadlines themselves are a
    # workload property, set at trace generation.
    slo_ttft: Optional[Dict[str, float]] = None
    # TPS/history retention: bucket memory and the forecaster's fitting
    # window are bounded by this lookback, independent of run length.
    # Runs shorter than the lookback see bit-identical history to the
    # old unbounded accounting.
    history_lookback: float = 8 * 86400.0
    # dollar accounting: CostModel pricing instance-hours in the Report;
    # None → the paper's flat α = $98.32/h
    cost_model: Optional[object] = None
    # scenario stress knobs (repro_torch.api.spec.ScenarioSpec): region outage
    # windows + per-region capacity caps; None → steady state
    scenario: Optional[object] = None
    # initial model placement {model: (regions,)}; None → every model
    # deployed in every region
    placement: Optional[Dict[str, Tuple[str, ...]]] = None


class Simulation:
    def __init__(self, requests: Sequence[Request], cfg: SimConfig,
                 models: Optional[List[str]] = None,
                 regions: Optional[List[str]] = None,
                 profiles: Optional[Dict[str, PerfProfile]] = None,
                 name: str = "sim"):
        self.cfg = cfg
        self.name = name
        self.requests = list(requests)
        self.models = models or sorted({r.model for r in requests})
        self.regions = regions or sorted({r.region for r in requests})
        self.profiles = profiles or {m: PROFILES[m] for m in self.models}
        order_fn = resolve("scheduler", cfg.scheduler)
        self.router = cfg.router if cfg.router is not None else resolve(
            "router", {"name": "threshold",
                       "kwargs": {"threshold": cfg.route_threshold}})

        pools = ("IW", "NIW") if cfg.siloed else ("unified",)
        per_pool = ({"IW": cfg.siloed_iw, "NIW": cfg.siloed_niw}
                    if cfg.siloed else
                    {"unified": cfg.initial_instances})
        region_caps = (dict(cfg.scenario.region_caps)
                       if cfg.scenario is not None
                       and getattr(cfg.scenario, "region_caps", None)
                       else None)
        self.cluster = Cluster(self.regions, self.models, self.profiles,
                               order_fn, pools=pools,
                               initial_per_pool=per_pool,
                               spot_spare=cfg.spot_spare,
                               cost_model=cfg.cost_model,
                               placement=cfg.placement,
                               region_caps=region_caps)
        # per-(model, pool) region → endpoint map for the routing hot path
        self._region_eps: Dict[Tuple[str, str], Dict[str, object]] = {
            (m, pool): {r: self.cluster.endpoint(m, r, pool)
                        for r in self.regions}
            for m in self.models for pool in pools}

        self._heap: List = []
        self._seq = itertools.count()
        self._inflight = 0       # non-control events currently in the heap
        self.events_processed = 0
        self.now = 0.0
        self.last_arrival = (max(r.arrival for r in requests)
                             if requests else 0.0)

        # observed input-TPS history per (model, region): bounded ring
        # buffers (memory O(lookback), not O(run length))
        keys = [(m, r) for m in self.models for r in self.regions]
        lookback = max(cfg.history_lookback,
                       3600.0 + 2 * cfg.tps_window)   # niw_last_hour floor
        self.tps = TpsHistory(keys, cfg.tps_window, lookback)
        self.niw_tps = TpsHistory(keys, cfg.tps_window, lookback)
        self.util_trace: Dict[Key, List[Tuple[float, float, int]]] = \
            defaultdict(list)
        self._next_sample = 0.0
        self.retry_dropped = 0

        # skip per-arrival EndpointView construction when the policy
        # inherits the base no-op on_request hook
        on_req = getattr(type(cfg.policy), "on_request", None)
        self._wants_request_hook = (
            on_req is not None and on_req is not ScalingPolicy.on_request)
        # routers may advertise a pure home-first threshold (see
        # ThresholdRouter.home_threshold): below it the home region always
        # wins, so the per-arrival utils map can be skipped entirely
        home_thr = capability(self.router, "home_threshold")
        self._home_thr = home_thr() if home_thr else None
        # plan-aware routers advertise per-request deterministic routing
        # (hash-based ω splitting) and a plan feed — both declared
        # capabilities, so the threshold-router hot path stays untouched
        self._route_request = capability(self.router, "route_request")
        self._router_update_plan = capability(self.router, "update_plan")
        # reused per-arrival routing inputs: lazy utils views per
        # (model, pool) and one preference list per home region
        self._lazy_utils = {k: _RegionUtils(v, self.regions)
                            for k, v in self._region_eps.items()}
        self._prefs = {r: [r] + [x for x in self.regions if x != r]
                       for r in self.regions}
        # policies may advertise a cheap pre-check (cooldown) that
        # predicts on_request cannot act, skipping the view build
        self._request_view_gate = capability(cfg.policy,
                                             "wants_request_view")
        # signals are only synthesized for policies that override the
        # base no-op observe
        obs = getattr(type(cfg.policy), "observe", None)
        self._wants_signals = (
            obs is not None and obs is not ScalingPolicy.observe)

        # planners may advertise the placement-state feed (a declared
        # capability, like the router ones above)
        ctl = cfg.controller
        self._feed_placement_state = (
            capability(ctl, "set_placement_state") if ctl else None)

        self.bus = HookBus()
        self.bus.subscribe(Arrival, self._on_arrival)
        self.bus.subscribe(Retry, self._on_retry)
        self.bus.subscribe(PrefillDone, self._on_prefill_done)
        self.bus.subscribe(DecodeDone, self._on_decode_done)
        self.bus.subscribe(InstanceReady, self._on_instance_ready)
        self.bus.subscribe(Tick, self._on_tick)
        self.bus.subscribe(Hour, self._on_hour)
        self.bus.subscribe(PlacementEffective, self._on_placement)
        self.bus.subscribe(OutageStart, self._on_outage_start)
        self.bus.subscribe(OutageEnd, self._on_outage_end)

    # --------------------------------------------------------------- helpers
    def _push(self, t: float, event: Event):
        if event.__class__ not in CONTROL_EVENT_SET:
            self._inflight += 1
        heapq.heappush(self._heap, (t, next(self._seq), event))

    def _note_tps(self, req: Request, region: str):
        v = req.prompt_tokens / self.cfg.tps_window
        self.tps.note((req.model, region), req.arrival, v)
        if req.tier == TIER_NIW:
            self.niw_tps.note((req.model, region), req.arrival, v)

    def observed_tps(self, horizon: float = 300.0) -> Dict[Key, float]:
        """Mean input TPS over the trailing `horizon` seconds."""
        return self.tps.window_mean(self.now, horizon, include_current=True)

    def history_series(self) -> Dict[Key, np.ndarray]:
        return self.tps.series(self.now)

    def niw_last_hour(self) -> Dict[Key, float]:
        return self.niw_tps.window_mean(self.now, 3600.0,
                                        include_current=False)

    # --------------------------------------------------------------- routing
    def _route_and_enqueue(self, req: Request, forced_region: str = None,
                           attempt: int = 0):
        cfg = self.cfg
        pool = ("unified" if not cfg.siloed else
                ("NIW" if req.tier == TIER_NIW else "IW"))
        eps = self._region_eps[(req.model, pool)]
        if forced_region is not None:
            region = forced_region
            ep = eps[region]
        else:
            region = req.region
            ep = eps[region]
            rr = self._route_request
            if rr is not None:
                routed = rr(req, self._lazy_utils[(req.model, pool)],
                            self._prefs[region])
                if routed != region:
                    region = routed
                    ep = eps[region]
            else:
                thr = self._home_thr
                if thr is None or ep.util >= thr:
                    utils = {r: eps[r].util for r in self.regions}
                    pref = [region] + [r for r in self.regions
                                       if r != region]
                    routed = self.router.route(utils, pref)
                    if routed != region:
                        region = routed
                        ep = eps[region]
        inst = ep.pick_jsq()
        if inst is None and (req.model, region) not in \
                self.cluster.deployed:
            # the picked region does not host the model (placement or
            # outage): spill to the nearest deployed region with live
            # capacity instead of burning retries against a dead
            # endpoint.  With the default all-placed stack this branch
            # never triggers.
            deployed = self.cluster.deployed
            for alt in self._prefs[req.region]:
                if alt != region and (req.model, alt) in deployed:
                    cand = eps[alt].pick_jsq()
                    if cand is not None:
                        region, ep, inst = alt, eps[alt], cand
                        break
        if inst is None:
            # endpoint has zero live instances: exponential backoff, then
            # drop (surfaced in Report.retry_dropped) instead of requeueing
            # forever
            if attempt >= cfg.max_retries:
                req.instance = "DROPPED-RETRY"
                self.retry_dropped += 1
                return
            delay = min(cfg.retry_base * (2.0 ** attempt), cfg.retry_cap)
            self._push(self.now + delay, Retry(req, attempt + 1))
            return
        ev = inst.enqueue(req, self.now)
        if ev:
            self._push(ev[1], self._pf_event(inst))
        # reactive per-request trigger (view built only for policies that
        # override the base no-op hook and pass their own pre-check)
        if self._wants_request_hook:
            gate = self._request_view_gate
            if gate is None or gate(req.model, region, pool, self.now):
                view = EndpointView(req.model, region, ep.util,
                                    ep.live_count(), len(ep.pending),
                                    0.0, pool)
                acts = cfg.policy.on_request(view, self.now)
                if acts:
                    self._apply_actions(acts)

    def _apply_actions(self, acts: List[ScaleAction]):
        for act in acts:
            if self.cfg.siloed and act.pool == "unified":
                act = dataclasses.replace(act, pool="IW")
            for kind, t, payload in self.cluster.apply_action(act, self.now):
                assert kind == "instance_ready"
                self._push(t, InstanceReady(payload))

    def _reset_outcomes(self):
        """Traces are reused across runs (sweeps over StackSpec grids);
        a request unserved in *this* run must not inherit a previous
        run's outcome or queue-manager promotion."""
        for r in self.requests:
            r.ttft = math.nan
            r.e2e = math.nan
            r.admitted = math.nan
            r.instance = None
            r.served_region = None
            if r.tier == TIER_NIW:
                r.priority = 1

    # ------------------------------------------------------------------ run
    def run(self) -> Report:
        cfg = self.cfg
        self._reset_outcomes()
        # arrivals stream from a sorted cursor — never materialized on the
        # heap (at 10M requests the old pre-heaped Arrival events dominated
        # memory and added a log-factor to every heap operation).  A stable
        # sort reproduces the old heap's (time, push-seq) order exactly.
        arrivals = self.requests
        arr_t = [r.arrival for r in arrivals]
        if len(arr_t) > 1 and bool(np.any(np.diff(np.asarray(arr_t)) < 0)):
            arrivals = sorted(arrivals, key=lambda r: r.arrival)
            arr_t = [r.arrival for r in arrivals]
        self._push(cfg.tick, Tick())
        self._push(3600.0, Hour())
        horizon = self.last_arrival + cfg.drain_grace
        if cfg.scenario is not None:
            for o in getattr(cfg.scenario, "outages", ()):
                self._push(o.start, OutageStart(o.region))
                self._push(o.end, OutageEnd(o.region))

        # single-subscriber fast paths: dispatch arrivals without
        # constructing an Arrival event per request, and heap events
        # without the publish indirection (multi-subscriber event types
        # fall back to the bus; subscribe before run(), not during)
        handlers = self.bus.handlers_for(Arrival)
        direct = (len(handlers) == 1 and handlers[0] == self._on_arrival)
        dispatch = {}
        for et in (Retry, PrefillDone, DecodeDone, InstanceReady,
                   Tick, Hour, PlacementEffective, OutageStart,
                   OutageEnd):
            hs = self.bus.handlers_for(et)
            if len(hs) == 1:
                dispatch[et] = hs[0]
        dispatch_get = dispatch.get

        heap = self._heap
        publish = self.bus.publish
        pop = heapq.heappop
        i, n = 0, len(arrivals)
        processed = 0
        while True:
            if i < n and (not heap or arr_t[i] <= heap[0][0]):
                t = arr_t[i]
                req = arrivals[i]
                i += 1
                if t > self.now:
                    self.now = t
                processed += 1
                if direct:
                    self._arrive(req)
                else:
                    publish(Arrival(req))
                continue
            if not heap:
                break
            t, _, ev = pop(heap)
            if ev.__class__ in CONTROL_EVENT_SET:
                # past the horizon control events may not extend the run on
                # their own: stop once no work events remain (O(1) counter,
                # the old any() scanned the whole heap per control event)
                if t > horizon and self._inflight == 0 and i >= n:
                    break
            else:
                self._inflight -= 1
            if t > self.now:
                self.now = t
            processed += 1
            h = dispatch_get(ev.__class__)
            if h is not None:
                h(ev)
            else:
                publish(ev)
        self.events_processed += processed

        self.cluster.accrue(self.now)
        parked = (cfg.queue_manager.depth()
                  if cfg.queue_manager is not None else 0)
        return build_report(self.name, self.requests, self.cluster,
                            dict(self.util_trace),
                            retry_dropped=self.retry_dropped,
                            parked=parked, slo_ttft=cfg.slo_ttft)

    @staticmethod
    def _pf_event(inst: Instance) -> PrefillDone:
        """Per-instance cached PrefillDone: at most one is ever live on
        the heap per instance (prefill slots are serial), so the event
        object is reusable."""
        ev = inst.pf_event
        if ev is None:
            ev = inst.pf_event = PrefillDone(inst)
        return ev

    # --------------------------------------------------------- event handlers
    def _arrive(self, req: Request):
        self._note_tps(req, req.region)
        if req.tier == TIER_NIW and self.cfg.queue_manager is not None:
            self.cfg.queue_manager.submit(req)
        else:
            self._route_and_enqueue(req)

    def _on_arrival(self, ev: Arrival):
        self._arrive(ev.request)

    def _on_retry(self, ev: Retry):
        self._route_and_enqueue(ev.request, attempt=ev.attempt)

    def _on_prefill_done(self, ev: PrefillDone):
        inst: Instance = ev.instance
        if inst.prefilling is None:
            return  # instance was drained/reaped
        req, finish, nxt = inst.on_prefill_done(self.now)
        self._push(finish, DecodeDone(inst, req))
        if nxt:
            self._push(nxt[1], self._pf_event(inst))

    def _on_decode_done(self, ev: DecodeDone):
        nxt = ev.instance.on_decode_done(ev.request, self.now)
        if nxt:
            self._push(nxt[1], self._pf_event(ev.instance))

    def _on_instance_ready(self, ev: InstanceReady):
        p: PendingInstance = ev.pending
        inst = self.cluster.on_instance_ready(p, self.now)
        if inst is None:
            return  # cancelled (undeployed / region failed) meanwhile
        started = inst.maybe_start_prefill(self.now)
        if started:
            self._push(started[1], self._pf_event(inst))

    # ----------------------------------------------------- placement/outages
    def _on_placement(self, ev: PlacementEffective):
        act = ev.action
        if act.deploy:
            self.cluster.deploy(act.model, act.region, self.now)
        else:
            self.cluster.undeploy(act.model, act.region, self.now)

    def _on_outage_start(self, ev: OutageStart):
        self.cluster.fail_region(ev.region, self.now)

    def _on_outage_end(self, ev: OutageEnd):
        self.cluster.restore_region(ev.region, self.now)

    # ----------------------------------------------------------------- ticks
    def _on_tick(self, ev: Tick):
        cfg = self.cfg
        self.cluster.accrue(self.now)
        self.cluster.reap_drained(self.now)
        observed = self.observed_tps()
        views = self.cluster.views(observed)

        # backlog signals: published only to policies that override the
        # base no-op ``observe``
        if cfg.queue_manager is not None and self._wants_signals:
            for m in self.models:
                backlog = cfg.queue_manager.backlog_tokens(m)
                for r in self.regions:
                    cfg.policy.observe(BacklogSignal(
                        m, r, backlog / len(self.regions)))
        acts = cfg.policy.on_tick(views, self.now)
        if acts:
            self._apply_actions(acts)

        # NIW queue-manager capacity signals (§6.2)
        if cfg.queue_manager is not None:
            pool = "NIW" if cfg.siloed else "unified"
            for m in self.models:
                eps = self._region_eps[(m, pool)]
                for r in self.regions:
                    ep = eps[r]
                    u = ep.util
                    live = ep.live_count()
                    if u < cfg.qm_signal_thresh and live > 0:
                        for req in cfg.queue_manager.on_capacity_signal(
                                m, r, u, self.now, live_instances=live):
                            self._route_and_enqueue(req, forced_region=r)
            for req in cfg.queue_manager.force_release_expiring(self.now):
                self._route_and_enqueue(req)

        # utilization sampling
        if self.now >= self._next_sample:
            for (m, r, pool), ep in self.cluster.endpoints.items():
                self.util_trace[(m, r)].append(
                    (self.now, ep.util,
                     ep.live_count() + len(ep.pending)))
            self._next_sample = self.now + cfg.sample_every

        horizon = self.last_arrival + cfg.drain_grace
        if self._heap or self.now < horizon:
            self._push(self.now + cfg.tick, Tick())

    def _on_hour(self, ev: Hour):
        cfg = self.cfg
        horizon = self.last_arrival + cfg.drain_grace
        if self.now + 3600.0 < horizon:
            self._push(self.now + 3600.0, Hour())
        if cfg.controller is None:
            return
        instances = {}
        for (m, r, pool), ep in self.cluster.endpoints.items():
            instances[(m, r)] = instances.get((m, r), 0) + \
                ep.live_count() + len(ep.pending)
        if self._feed_placement_state is not None:
            self._feed_placement_state(
                self.cluster.placement_state(self.now))
        plan = cfg.controller.plan(
            self.now, instances, self.history_series(), self.niw_last_hour())
        if isinstance(plan, tuple):
            # legacy planners return a bare (targets, forecasts) pair
            targets, forecasts = plan
            plan = Plan(t=self.now, targets=targets, forecasts=forecasts)
        # stage placement transitions first: undeploys (lead 0) free
        # capacity before the scaler actuates this hour's targets, and
        # deploys fire at now + lead — live no earlier than issued + lead
        if plan.placement is not None:
            for act in plan.placement.actions:
                if act.effective_at <= self.now:
                    self._on_placement(PlacementEffective(act))
                else:
                    self._push(act.effective_at, PlacementEffective(act))
        acts = cfg.policy.set_targets(plan.targets, plan.forecasts,
                                      self.now)
        if acts:
            self._apply_actions(acts)
        if self._router_update_plan is not None:
            self._router_update_plan(plan, self.now)
