"""SageServe controller (§6.3): hourly forecast → ILP → one ``Plan``.

Every hour: refresh the per-(model, region) input-TPS forecasts (all
series stacked into one :class:`BatchForecastEngine` fit, a CUDA kernel
launch unless the controller was given ``device="cpu"``, with
warm-started parameters; a serial per-series path remains for
reference), take the max of the next hour's forecast, add the NIW
buffer β = ``buffer_frac`` × last-hour NIW load, solve the §5 ILP —
optionally extended with cross-region spill fractions ω and placement
binaries y — and emit a single :class:`repro_torch.api.plan.Plan`: instance
targets (n + δ), the forecasts, the routing split, the staged placement
actions and the solver's dollar objective.  The scaling policy (LT-I /
LT-U / LT-UA) actuates the targets at its own pace; a plan-aware router
consumes the ω fractions; the cluster actuates each placement action at
its lead-time-staged ``effective_at``.

Placement transitions are priced by their actuation lead: a (model,
region) with a warm model-tagged spot VM deploys at the ~1 min role
flip, one whose weights are in-region at the ~10 min local load, and a
never-placed pair pays the ~2 h remote fetch.  The planner learns those
leads from the cluster's :class:`repro_torch.api.plan.PlacementState`, fed via
the duck-typed ``set_placement_state`` capability before each ``plan``;
known maintenance windows (``outages``) make a region non-deployable
for any plan whose actuation would overlap them — the forecast-aware
controller evacuates *ahead* of the outage rather than reacting to it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.api.plan import (PlacementAction, PlacementPlan,
                                  PlacementState, Plan, RoutingPlan)
from repro_torch.api.registry import register
from repro_torch.control.amortize import solve_amortized
from repro_torch.control.cost import DEFAULT_DOLLARS_PER_HOUR
from repro_torch.control.forecast import ARIMAForecaster, BatchForecastEngine
from repro_torch.control.provision import (ProvisionProblem,
                                           ProvisionSolution, solve,
                                           solve_with_routing)

Key = Tuple[str, str]

#: (spot retag, local weight load, remote weight fetch) seconds — the
#: defaults of :class:`repro_torch.sim.perfmodel.PerfProfile`.
DEFAULT_PLACE_LEADS = (60.0, 600.0, 7200.0)


@dataclasses.dataclass
class ControllerConfig:
    models: Sequence[str]
    regions: Sequence[str]
    theta: Dict[str, float]           # TPS per instance, per model
    alpha: float = DEFAULT_DOLLARS_PER_HOUR   # VM cost ($/h per paper)
    startup_time: Dict[str, float] = dataclasses.field(default_factory=dict)
    epsilon: float = 0.8
    buffer_frac: float = 0.10         # β = 10% of last-hour NIW load
    min_instances: int = 2
    max_instances: Optional[int] = None
    region_cap: Optional[float] = None
    arima_order: Tuple[int, int, int] = (2, 1, 1)
    seasonal_period: int = 0
    fit_steps: int = 200
    window_sec: float = 60.0          # TPS history bucket width
    horizon_windows: int = 60         # forecast next hour in 1-min windows
    batched: bool = True              # stacked fits vs serial
    use_routing: bool = False         # co-optimize ω spill fractions
    spill_cost_per_tps: float = 1e-3  # λ: tie-break toward local serving
    plan_horizon: float = 3600.0      # Plan validity window (s)
    # placement knob (implies use_routing: y gates the ω fractions)
    use_placement: bool = False
    # a deployable (model, region) whose forecast home demand exceeds
    # this fraction of one instance's θ is pinned placed (y = 1): real
    # home demand keeps — or pulls — a deployment, honoring the paper's
    # ε in-region preference, while near-idle endpoints consolidate
    # away.  Without the pin the tiny spill penalty λ would let the ILP
    # undeploy loaded homes and serve everything cross-region, trading
    # SLA headroom for dollars.
    undeploy_max_theta_frac: float = 0.5
    # per-model (spot retag, local load, remote fetch) actuation leads
    place_leads: Dict[str, Tuple[float, float, float]] = \
        dataclasses.field(default_factory=dict)
    # known maintenance windows: (region, start_s, end_s) — a region is
    # non-deployable for plans whose actuation overlaps one
    outages: Tuple[Tuple[str, float, float], ...] = ()
    # per-region instance caps (overrides the scalar region_cap)
    region_caps: Optional[Dict[str, float]] = None
    # dedupe identical hourly ILPs across replicas/hours through the
    # process-wide fingerprint cache (repro_torch.control.amortize).  The
    # solver is deterministic, so a cache hit is bit-identical to
    # re-solving; disable only to benchmark the cold path.
    amortize_ilp: bool = True


class SageServeController:
    def __init__(self, cfg: ControllerConfig, device: DeviceLike = None):
        """``device``: where the forecast fits run (CUDA unless "cpu")."""
        self.cfg = cfg
        p, d, q = cfg.arima_order
        self.engine = BatchForecastEngine(
            p=p, d=d, q=q, seasonal_period=cfg.seasonal_period,
            fit_steps=cfg.fit_steps, device=device)
        self.last_forecast: Dict[Key, float] = {}
        self.last_solution: Optional[ProvisionSolution] = None
        self.last_plan: Optional[Plan] = None
        self.solve_history: List[Dict] = []
        # placement bookkeeping: the cluster's live state (fed via the
        # duck-typed set_placement_state capability), which keys hold
        # the model's weights in-region (cluster truth only — pricing a
        # deploy as local before its fetch completed would actuate it
        # early), and deploy actions still in flight (staged but not
        # yet effective), so hourly replans don't re-stage them
        self.placement_state: Optional[PlacementState] = None
        self._weights_local: set = set()
        self._staged_deploys: Dict[Key, float] = {}   # key -> effective_at
        self._blocks: Dict[Key, Tuple[float, float]] = {}  # outage windows

    # ---------------------------------------------------------- placement
    def set_placement_state(self, state: PlacementState) -> None:
        """Duck-typed capability: the simulator (or live control plane)
        pushes the cluster's deployment/warmth snapshot before each
        hourly ``plan`` call."""
        self.placement_state = state
        self._weights_local.update(state.weights_local)

    def _lead_time(self, model: str, region: str) -> float:
        """Actuation lead of deploying ``model`` into ``region``: warm
        spot retag < local weight load < remote fetch."""
        swap, local, remote = self.cfg.place_leads.get(
            model, DEFAULT_PLACE_LEADS)
        st = self.placement_state
        if st is not None and st.warm_spot.get((model, region), 0) > 0:
            return swap
        if st is None or (model, region) in self._weights_local:
            return local
        return remote

    def _region_block(self, region: str, now: float, lead: float
                      ) -> Optional[float]:
        """When (if ever) the region becomes unusable for this plan:
        ``now`` if it is already down, the start of a known outage
        window overlapping the actuation span [now, now + lead +
        horizon], or None when the region is deployable throughout.
        Evacuation undeploys are staged at this time — capacity serves
        until the outage actually hits, it is not drained a full
        planning period early."""
        st = self.placement_state
        if st is not None and region in st.down_regions:
            return now
        hi = now + lead + self.cfg.plan_horizon
        for rg, start, end in self.cfg.outages:
            if rg == region and start < hi and end > now:
                return max(start, now)
        return None

    # ------------------------------------------------------------- forecast
    def forecast_spec(self) -> Optional[Tuple]:
        """Duck-typed capability: the fit configuration under which this
        controller's forecasts can be batched *fleet-wide* — replicas
        whose specs compare equal may have their histories stacked into
        one shared ``fit_forecast`` call (see
        :class:`repro_torch.control.fleet.FleetForecast`).  ``None`` opts out
        (serial engines keep their per-replica path)."""
        cfg = self.cfg
        if not cfg.batched:
            return None
        p, d, q = cfg.arima_order
        return (p, d, q, cfg.seasonal_period, cfg.fit_steps,
                cfg.horizon_windows)

    def forecast_peaks(self, history: Dict[Key, np.ndarray],
                       fitted: Optional[Dict[Key, np.ndarray]] = None
                       ) -> Dict[Key, float]:
        peaks: Dict[Key, float] = {}
        if fitted is None:
            fit = (self.engine.fit_forecast if self.cfg.batched
                   else self.engine.fit_forecast_serial)
            fitted = fit(history, self.cfg.horizon_windows)
        # sorted: peak emission order must not depend on caller dict order
        for key, series in sorted(history.items()):
            fc = fitted.get(key)
            if fc is None:
                # not enough history: persist current level
                series = np.asarray(series, float)
                peaks[key] = float(series.max()) if len(series) else 0.0
            else:
                peaks[key] = float(np.max(fc))
            series = np.asarray(series, float)
            tail = series[-1440:] if len(series) else series
            obs = float(tail.max()) if len(tail) else 0.0
            if not np.isfinite(peaks[key]) or peaks[key] > 16.0 * obs + 1.0:
                # a diverged fit (warm-started params can blow up on
                # sparse series) must not poison the ILP — and a blown-up
                # fit is not always inf: an hourly peak orders of
                # magnitude above anything observed in the last day is
                # divergence, not forecast.  Fall back to the observed
                # recent peak.
                peaks[key] = obs
            self.last_forecast[key] = peaks[key]
        return peaks

    # ------------------------------------------------------------------ ILP
    def plan_fitted(self, now: float,
                    instances: Dict[Key, int],
                    history: Dict[Key, np.ndarray],
                    niw_last_hour_tps: Dict[Key, float],
                    fitted: Dict[Key, np.ndarray]) -> Plan:
        """Duck-typed capability: like :meth:`plan`, but consuming
        forecasts already fitted by a fleet-wide batched engine (one
        stacked fit per boundary across replicas) instead of running
        this controller's own engine."""
        return self.plan(now, instances, history, niw_last_hour_tps,
                         fitted=fitted)

    def plan(self, now: float,
             instances: Dict[Key, int],
             history: Dict[Key, np.ndarray],
             niw_last_hour_tps: Dict[Key, float],
             fitted: Optional[Dict[Key, np.ndarray]] = None) -> Plan:
        """One hourly control decision: forecast, solve, emit the Plan."""
        cfg = self.cfg
        models, regions = list(cfg.models), list(cfg.regions)
        l, r = len(models), len(regions)
        t0 = time.perf_counter()
        peaks = self.forecast_peaks(history, fitted=fitted)
        t_forecast = time.perf_counter() - t0

        n = np.zeros((l, r, 1))
        rho = np.zeros((l, r))
        buf = np.zeros((l, r))
        theta = np.zeros((l, 1))
        sigma = np.zeros((l, 1))
        for i, m in enumerate(models):
            theta[i, 0] = cfg.theta[m]
            sigma[i, 0] = cfg.alpha * cfg.startup_time.get(m, 600.0) / 3600.0
            for j, rg in enumerate(regions):
                n[i, j, 0] = instances.get((m, rg), 0)
                rho[i, j] = peaks.get((m, rg), 0.0)
                buf[i, j] = cfg.buffer_frac * niw_last_hour_tps.get(
                    (m, rg), 0.0)

        region_cap = None
        if cfg.region_caps is not None:
            region_cap = np.array([
                cfg.region_caps.get(rg, cfg.region_cap or np.inf)
                for rg in regions])
        elif cfg.region_cap:
            region_cap = np.full(r, cfg.region_cap)

        placed = place_cost = deployable = pinned = leads = None
        if cfg.use_placement:
            st = self.placement_state
            placed = np.ones((l, r))
            place_cost = np.zeros((l, r))
            deployable = np.ones((l, r), bool)
            pinned = np.zeros((l, r), bool)
            leads = np.zeros((l, r))
            self._blocks = blocks = {}
            for i, m in enumerate(models):
                for j, rg in enumerate(regions):
                    if st is not None:
                        placed[i, j] = 1.0 if (m, rg) in st.placed else 0.0
                    leads[i, j] = self._lead_time(m, rg)
                    block = self._region_block(rg, now, leads[i, j])
                    deployable[i, j] = block is None
                    if block is not None:
                        blocks[(m, rg)] = block
                    if placed[i, j] < 0.5:
                        # dollar cost of the deploy lead: VMs provision
                        # but serve nothing while the weights arrive
                        place_cost[i, j] = cfg.alpha * leads[i, j] / 3600.0
                    if deployable[i, j] and (
                            rho[i, j] + buf[i, j]
                            > cfg.undeploy_max_theta_frac * theta[i, 0]):
                        pinned[i, j] = True

        prob = ProvisionProblem(
            n=n, theta=theta, alpha=np.array([cfg.alpha]), sigma=sigma,
            rho_peak=rho, epsilon=cfg.epsilon,
            region_cap=region_cap,
            min_instances=cfg.min_instances,
            max_instances=cfg.max_instances, buffer=buf,
            placed=placed, place_cost=place_cost, deployable=deployable,
            pinned=pinned)
        t0 = time.perf_counter()
        if cfg.use_routing or cfg.use_placement:
            sol = self._solve_routing(prob)
            if cfg.use_placement and sol.status == "infeasible":
                # e.g. demand exists but no region is deployable for a
                # model: degrade to the placement-blind program rather
                # than emitting an empty plan
                prob = dataclasses.replace(prob, placed=None,
                                           place_cost=None,
                                           deployable=None, pinned=None)
                sol = self._solve_routing(prob)
        elif cfg.amortize_ilp:
            sol = solve_amortized(prob)
        else:
            sol = solve(prob)
        t_ilp = time.perf_counter() - t0
        self.last_solution = sol
        self.solve_history.append(
            {"t": now, "objective": sol.objective, "status": sol.status,
             "forecast_s": t_forecast, "ilp_s": t_ilp})

        targets: Dict[Key, int] = {}
        forecasts: Dict[Key, float] = {}
        for i, m in enumerate(models):
            for j, rg in enumerate(regions):
                targets[(m, rg)] = int(round(n[i, j, 0]
                                             + sol.delta[i, j, 0]))
                forecasts[(m, rg)] = rho[i, j]

        routing = None
        if sol.omega is not None:
            routing = _routing_plan(sol.omega, rho + buf, models, regions)
        placement = None
        if sol.y is not None:
            placement = self._placement_plan(sol.y, placed, leads,
                                             models, regions, now)
        plan = Plan(t=now, targets=targets, forecasts=forecasts,
                    routing=routing, placement=placement,
                    horizon=cfg.plan_horizon,
                    cost_estimate=float(sol.objective), status=sol.status)
        self.last_plan = plan
        return plan

    def _solve_routing(self, prob: ProvisionProblem) -> ProvisionSolution:
        cfg = self.cfg
        if cfg.amortize_ilp:
            return solve_amortized(
                prob, use_routing=True,
                spill_cost_per_tps=cfg.spill_cost_per_tps)
        return solve_with_routing(
            prob, spill_cost_per_tps=cfg.spill_cost_per_tps)

    def _placement_plan(self, y: np.ndarray, placed: np.ndarray,
                        leads: np.ndarray, models: Sequence[str],
                        regions: Sequence[str], now: float
                        ) -> PlacementPlan:
        """Diff the ILP's target placement against the current one into
        staged actions: deploys actuate after their lead time; undeploys
        drain immediately when demand left, or — for evacuations ahead
        of a known outage — at the moment the region actually becomes
        unusable, so capacity keeps serving until the outage hits."""
        blocks = self._blocks
        staged = self._staged_deploys
        for key in [k for k, eff in staged.items() if eff <= now]:
            del staged[key]   # actuated by now: cluster state has it
        placed_out: Dict[Key, bool] = {}
        actions: List[PlacementAction] = []
        for i, m in enumerate(models):
            for j, rg in enumerate(regions):
                want = bool(y[i, j] > 0.5)
                placed_out[(m, rg)] = want
                if want == bool(placed[i, j] > 0.5):
                    if not want:
                        staged.pop((m, rg), None)
                    continue
                if want:
                    if staged.get((m, rg), -math.inf) > now:
                        continue   # deploy already in flight: no re-stage
                    lead = float(leads[i, j])
                    staged[(m, rg)] = now + lead
                else:
                    lead = max(0.0, blocks.get((m, rg), now) - now)
                    staged.pop((m, rg), None)
                actions.append(PlacementAction(
                    model=m, region=rg, deploy=want,
                    issued_at=now, lead_time=lead))
        return PlacementPlan(placed=placed_out, actions=actions)


def _routing_plan(omega: np.ndarray, demand: np.ndarray,
                  models: Sequence[str], regions: Sequence[str]
                  ) -> RoutingPlan:
    """ω (l, r, r) → per-(model, home) fraction dicts.  Zero-demand keys
    are omitted (their ω rows are unconstrained by the objective), and
    each emitted row is clipped/renormalized against solver round-off."""
    fractions: Dict[Key, Dict[str, float]] = {}
    for i, m in enumerate(models):
        for j, home in enumerate(regions):
            if demand[i, j] <= 1e-9:
                continue
            row = np.clip(omega[i, j], 0.0, 1.0)
            total = row.sum()
            if total <= 1e-9:
                continue
            row = row / total
            fractions[(m, home)] = {
                regions[jp]: float(row[jp]) for jp in range(len(regions))
                if row[jp] > 1e-6}
    return RoutingPlan(fractions=fractions)


@register("planner", "sageserve")
def _make_sageserve_planner(ctx, theta=None, theta_headroom: float = 0.7,
                            **kwargs) -> SageServeController:
    """GlobalPlanner factory: per-model θ (sustained input TPS per
    instance, derated by ``theta_headroom`` to protect tail latency)
    defaults from the build context's perf profiles.  The seasonal
    period defaults to one day of ``window_sec`` buckets — or one full
    week when the stack retains enough TPS history for two weekly
    periods (lookback >= 14 days), so weekly structure in the workload
    (weekend quiescing, repro_torch.workloads weekly harmonics) differences
    out of the forecast instead of aliasing into the daily period.
    Either way the period is capped so two full periods fit inside the
    lookback; the default 8-day lookback keeps the one-day period.  The
    forecast fits run on the build context's device."""
    if theta is None:
        if ctx is None:
            raise ValueError("planner 'sageserve' needs either explicit "
                             "theta or a build context with profiles")
        from repro_torch.sim.perfmodel import sustained_input_tps
        theta = {m: theta_headroom * sustained_input_tps(p)
                 for m, p in ctx.profiles.items()}
    if ctx is not None:
        kwargs.setdefault("window_sec", getattr(ctx, "tps_window", 60.0))
        if "seasonal_period" not in kwargs:
            lookback = getattr(ctx, "history_lookback", 8 * 86400.0)
            week = 7 * 86400.0
            period_sec = week if lookback / 2 >= week else 86400.0
            kwargs["seasonal_period"] = int(
                min(period_sec, lookback / 2) // kwargs["window_sec"])
        if "place_leads" not in kwargs:
            kwargs["place_leads"] = {
                m: (p.spot_swap_time, p.load_time_local,
                    p.load_time_remote)
                for m, p in ctx.profiles.items()}
        scen = getattr(ctx, "scenario", None)
        if scen is not None:
            kwargs.setdefault("outages", tuple(
                (o.region, o.start, o.end) for o in scen.outages))
            if scen.region_caps:
                kwargs.setdefault("region_caps",
                                  dict(scen.region_caps))
    return SageServeController(ControllerConfig(
        models=list(ctx.models) if ctx else list(theta),
        regions=list(ctx.regions) if ctx else [],
        theta=theta, **kwargs), device=getattr(ctx, "device", None))
