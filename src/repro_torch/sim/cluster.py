"""Cluster state: regions × model endpoints × instances, spot pool,
provisioning delays, instance-hour accounting.

Provisioning timeline (§2.3/§4): scale-out prefers a spot instance that
last hosted the *same* model (~1 min role flip); otherwise a spot VM of
another model is reclaimed and redeployed (~10 min local weights, ~2 h
remote); scale-in drains the instance and donates it to the spot pool.
Time spent provisioning is counted as wasted GPU time; time in the spot
pool is donated (leased) time, a recovered opportunity cost.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, \
    Set, Tuple

from repro_torch.api.plan import PlacementState
from repro_torch.control.cost import CostModel
from repro_torch.core.scaling import EndpointView, ScaleAction
from repro_torch.sim.instance import Instance
from repro_torch.sim.perfmodel import PerfProfile
from repro_torch.sim.types import Request

Key = Tuple[str, str]

# rebuild the lazy JSQ heap once stale entries outnumber live ones by this
_HEAP_COMPACT_SLACK = 64
_HEAP_COMPACT_FACTOR = 8


@dataclasses.dataclass
class PendingInstance:
    ready_at: float
    issued_at: float
    model: str
    region: str
    pool: str
    cancelled: bool = False   # undeployed/failed before coming up


@dataclasses.dataclass
class SpotVM:
    last_model: Optional[str]
    since: float


class Endpoint:
    """All instances of one model in one region (optionally per pool).

    Per-arrival queries (``util``, ``live_count``, ``pick_jsq``) are O(1)
    amortized: the endpoint subscribes to every instance's load-change
    hook and maintains (a) the summed reserved KV tokens over live
    instances — utilization is exact integer bookkeeping, never a float
    drift-accumulator — and (b) a lazy min-heap over ``(remaining_tokens,
    iid)`` for JSQ.  Heap entries are invalidated by comparison against
    the instance's current load and compacted when stale entries pile up,
    so routing cost no longer grows with fleet size (the pre-refactor
    full scans were the dominant super-linear term at production scale).
    """

    def __init__(self, model: str, region: str, profile: PerfProfile,
                 order_fn: Callable, pool: str = "unified"):
        self.model = model
        self.region = region
        self.profile = profile
        self.order_fn = order_fn
        self.pool = pool
        self.instances: Dict[str, Instance] = {}
        self.pending: List[PendingInstance] = []
        self._iid = itertools.count()
        # incremental aggregates over live (non-draining) instances
        self._live = 0
        self._reserved_sum = 0
        self._jsq_heap: List[Tuple[int, str]] = []
        self._draining: Set[str] = set()
        self._compact_at = _HEAP_COMPACT_SLACK

    def new_instance(self, now: float) -> Instance:
        iid = f"{self.model}/{self.region}/{self.pool}/{next(self._iid)}"
        inst = Instance(iid, self.model, self.region, self.profile,
                        self.order_fn)
        inst.acquired_at = now
        inst.listener = self._on_instance_change
        self.instances[iid] = inst
        self._live += 1
        self._compact_at = _HEAP_COMPACT_SLACK + \
            _HEAP_COMPACT_FACTOR * len(self.instances)
        heapq.heappush(self._jsq_heap, (inst.rem, iid))
        return inst

    # ------------------------------------------------------- O(1) aggregates
    def _on_instance_change(self, inst: Instance, d_reserved: int,
                            d_remaining: int) -> None:
        if inst.draining:
            return  # already removed from the live aggregates
        if d_reserved:
            self._reserved_sum += d_reserved
        if d_remaining:
            heap = self._jsq_heap
            heapq.heappush(heap, (inst.rem, inst.iid))
            if len(heap) > self._compact_at:
                self._compact_heap()

    def _compact_heap(self) -> None:
        self._jsq_heap = [(i.rem, iid)
                          for iid, i in self.instances.items()
                          if not i.draining]
        heapq.heapify(self._jsq_heap)

    def drain(self, inst: Instance) -> None:
        """Mark for scale-in: leaves the live aggregates immediately."""
        if inst.draining:
            return
        inst.draining = True
        self._live -= 1
        self._reserved_sum -= inst.reserved_tokens
        self._draining.add(inst.iid)

    def remove(self, inst: Instance) -> None:
        """Reap a drained instance (stale heap entries expire lazily)."""
        del self.instances[inst.iid]
        self._draining.discard(inst.iid)
        self._compact_at = _HEAP_COMPACT_SLACK + \
            _HEAP_COMPACT_FACTOR * len(self.instances)
        inst.listener = None

    def drained_idle(self) -> List[Instance]:
        """Draining instances that have gone idle — O(draining), not
        O(fleet), so the per-tick reap scan stays cheap."""
        # sorted: set order is hash-seed dependent, and reap order feeds
        # the spot-pool free list (and thus future warm-VM selection)
        return [self.instances[iid] for iid in sorted(self._draining)
                if self.instances[iid].idle]

    @property
    def util(self) -> float:
        if not self._live:
            return 1.0  # no capacity == saturated for routing purposes
        # reserved <= kv_capacity per instance (admission control), so the
        # per-instance min(, 1.0) clamp of Instance.util never binds and
        # the mean reduces to an exact integer-sum ratio
        return self._reserved_sum / self.profile.kv_capacity_tokens \
            / self._live

    def live_count(self) -> int:
        return self._live

    def pick_jsq(self) -> Optional[Instance]:
        heap = self._jsq_heap
        instances = self.instances
        while heap:
            rem, iid = heap[0]
            inst = instances.get(iid)
            if inst is None or inst.draining or rem != inst.rem:
                heapq.heappop(heap)  # stale: superseded or gone
                continue
            return inst
        return None

    def scan_check(self) -> None:
        """Debug/test hook: assert the O(1) aggregates equal full scans."""
        live = [i for i in self.instances.values() if not i.draining]
        assert self._live == len(live)
        assert self._reserved_sum == sum(i.reserved_tokens for i in live)
        for i in self.instances.values():
            assert i.rem == i._remaining_scan(), i.iid
        want = (min(live, key=lambda i: (i.remaining_tokens(), i.iid))
                if live else None)
        got = self.pick_jsq()
        if want is None:
            assert got is None
        else:
            assert got is not None
            assert ((got.remaining_tokens(), got.iid)
                    == (want.remaining_tokens(), want.iid))


class Cluster:
    def __init__(self, regions: List[str], models: List[str],
                 profiles: Dict[str, PerfProfile], order_fn: Callable,
                 initial_instances: int = 20, spot_spare: int = 10,
                 pools: Tuple[str, ...] = ("unified",),
                 initial_per_pool: Optional[Dict[str, int]] = None,
                 spot_retag_time: float = 600.0,
                 cost_model: Optional[CostModel] = None,
                 placement: Optional[Mapping[str, Sequence[str]]] = None,
                 region_caps: Optional[Mapping[str, int]] = None):
        # spot VMs donated to external (preemptible) customers are
        # redeployed with the customer's model after ~spot_retag_time;
        # reclaiming them then costs a full model redeploy (~10 min)
        # instead of the 1-min same-model role flip.  Frequent reactive
        # churn therefore pays cold starts that rare, forecast-driven
        # scaling amortizes (Fig. 1 / §7.2.4 of the paper).
        self.spot_retag_time = spot_retag_time
        self.cost_model = cost_model if cost_model is not None \
            else CostModel()
        self.regions = regions
        self.models = models
        self.profiles = profiles
        self.endpoints: Dict[Tuple[str, str, str], Endpoint] = {}
        self.spot: Dict[str, List[SpotVM]] = {r: [] for r in regions}

        # placement: which (model, region) pairs are deployed (accept
        # instances and traffic) and which regions hold which weights
        # locally.  None → the all-models-everywhere baseline.
        self.deployed: Set[Key] = {
            (m, r) for m in models for r in regions
            if placement is None or r in placement.get(m, ())}
        self.weights_local: Dict[str, Set[str]] = {
            r: {m for m in models if (m, r) in self.deployed}
            for r in regions}
        self.down_regions: Set[str] = set()
        self.region_caps: Dict[str, int] = dict(region_caps or {})
        self.deploy_events = 0
        self.undeploy_events = 0

        # accounting ---------------------------------------------------------
        self.instance_seconds: Dict[Key, float] = {}
        self.wasted_seconds: Dict[Key, float] = {}   # provisioning
        self.spot_seconds: Dict[str, float] = {r: 0.0 for r in regions}
        self.scale_out_events = 0
        self.scale_in_events = 0
        self._last_acct = 0.0

        for r in regions:
            for m in models:
                for pool in pools:
                    ep = Endpoint(m, r, profiles[m], order_fn, pool)
                    self.endpoints[(m, r, pool)] = ep
                    if (m, r) not in self.deployed:
                        continue  # undeployed pairs start empty
                    n0 = (initial_per_pool or {}).get(
                        pool, initial_instances // max(len(pools), 1))
                    for _ in range(n0):
                        ep.new_instance(0.0)
                self.instance_seconds[(m, r)] = 0.0
                self.wasted_seconds[(m, r)] = 0.0
            self.spot[r] = [SpotVM(None, 0.0) for _ in range(spot_spare)]
        self.pools = pools

    # ------------------------------------------------------------ accounting
    def accrue(self, now: float) -> None:
        dt = now - self._last_acct
        if dt <= 0:
            return
        for (m, r, pool), ep in self.endpoints.items():
            cnt = len(ep.instances) + len(ep.pending)
            self.instance_seconds[(m, r)] += dt * cnt
            self.wasted_seconds[(m, r)] += dt * len(ep.pending)
        for r, pool in self.spot.items():
            self.spot_seconds[r] += dt * len(pool)
        self._last_acct = now

    # --------------------------------------------------------------- lookups
    def endpoint(self, model: str, region: str, pool: str = "unified"
                 ) -> Endpoint:
        return self.endpoints[(model, region, pool)]

    def region_utils(self, model: str, pool: str = "unified"
                     ) -> Dict[str, float]:
        return {r: self.endpoints[(model, r, pool)].util
                for r in self.regions}

    def views(self, observed_tps: Dict[Key, float]) -> List[EndpointView]:
        out = []
        for (m, r, pool), ep in self.endpoints.items():
            out.append(EndpointView(
                model=m, region=r, util=ep.util,
                instances=ep.live_count(), pending=len(ep.pending),
                observed_tps=observed_tps.get((m, r), 0.0), pool=pool))
        return out

    # ---------------------------------------------------------------- scaling
    def apply_action(self, act: ScaleAction, now: float
                     ) -> List[Tuple[str, float, PendingInstance]]:
        """Returns provisioning events [("instance_ready", t, pending)].

        Scale-outs are refused for (model, region) pairs that are not
        deployed — placement, not the scaler, decides where a model may
        run — and for regions currently down."""
        self.accrue(now)
        ep = self.endpoints[(act.model, act.region, act.pool)]
        events = []
        if act.delta > 0:
            if (act.model, act.region) not in self.deployed \
                    or act.region in self.down_regions:
                return events
            for _ in range(act.delta):
                delay = self._acquire_delay(act.model, act.region, now)
                if delay is None:
                    break  # no VM available in region
                p = PendingInstance(now + delay, now, act.model, act.region,
                                    act.pool)
                ep.pending.append(p)
                events.append(("instance_ready", now + delay, p))
                self.scale_out_events += 1
        else:
            for _ in range(-act.delta):
                victim = self._pick_drain(ep)
                if victim is None:
                    break
                ep.drain(victim)
                self.scale_in_events += 1
        return events

    def region_instances(self, region: str) -> int:
        """Live + pending instances across all models/pools in a region
        (the quantity scenario ``region_caps`` bound)."""
        return sum(len(ep.instances) + len(ep.pending)
                   for (m, r, pool), ep in self.endpoints.items()
                   if r == region)

    def _acquire_delay(self, model: str, region: str, now: float
                       ) -> Optional[float]:
        if region in self.down_regions:
            return None
        cap = self.region_caps.get(region)
        if cap is not None and self.region_instances(region) >= cap:
            return None
        pool = self.spot[region]
        if not pool:
            return None
        prof = self.profiles[model]
        same = next((v for v in pool if v.last_model == model
                     and now - v.since < self.spot_retag_time), None)
        if same is not None:
            pool.remove(same)
            return prof.spot_swap_time
        # Paying a full load anyway: evict a VM whose warm tag serves no
        # future demand — untagged or past the retag window — before
        # sacrificing a warm model-tagged VM a later acquire could have
        # cheap-swapped.  Among warm VMs, evict the one closest to
        # expiry.
        victim = next((v for v in pool if v.last_model is None
                       or now - v.since >= self.spot_retag_time), None)
        if victim is None:
            victim = min(pool, key=lambda v: v.since)
        pool.remove(victim)
        if model not in self.weights_local[region]:
            # weights not in-region: remote fetch, local thereafter
            self.weights_local[region].add(model)
            return prof.load_time_remote
        return prof.load_time_local

    def _pick_drain(self, ep: Endpoint) -> Optional[Instance]:
        live = [i for i in ep.instances.values() if not i.draining]
        if not live:
            return None
        return min(live, key=lambda i: i.reserved_tokens)

    def on_instance_ready(self, p: PendingInstance, now: float
                          ) -> Optional[Instance]:
        self.accrue(now)
        ep = self.endpoints[(p.model, p.region, p.pool)]
        if p in ep.pending:
            ep.pending.remove(p)
        if p.cancelled or (p.model, p.region) not in self.deployed \
                or p.region in self.down_regions:
            # undeployed (or failed) while provisioning: the VM goes
            # back to the pool instead of serving
            self.spot[p.region].append(SpotVM(p.model, now))
            return None
        return ep.new_instance(now)

    def reap_drained(self, now: float) -> int:
        """Return drained+idle instances to the regional spot pool."""
        self.accrue(now)
        n = 0
        for (m, r, pool), ep in self.endpoints.items():
            for inst in ep.drained_idle():
                ep.remove(inst)
                self.spot[r].append(SpotVM(m, now))
                n += 1
        return n

    # -------------------------------------------------------------- placement
    def is_deployed(self, model: str, region: str) -> bool:
        return (model, region) in self.deployed

    def deploy(self, model: str, region: str, now: float) -> bool:
        """Actuate a staged deploy: the lead time already covered the
        weight distribution, so the region serves local loads from here
        on.  Instances arrive via the scaler's next targets."""
        if region in self.down_regions:
            return False
        if (model, region) in self.deployed:
            return True
        self.accrue(now)
        self.deployed.add((model, region))
        self.weights_local[region].add(model)
        self.deploy_events += 1
        return True

    def undeploy(self, model: str, region: str, now: float) -> int:
        """Drain-then-retag: every live instance of the pair drains (the
        reap donates it to the spot pool tagged with the model, so a
        re-deploy within the retag window is a cheap role flip); pending
        acquisitions are cancelled.  Returns instances drained."""
        if (model, region) not in self.deployed:
            return 0
        self.accrue(now)
        self.deployed.discard((model, region))
        n = 0
        for pool in self.pools:
            ep = self.endpoints[(model, region, pool)]
            for p in ep.pending:
                p.cancelled = True
            for inst in list(ep.instances.values()):
                if not inst.draining:
                    ep.drain(inst)
                    n += 1
        self.scale_in_events += n
        self.undeploy_events += 1
        return n

    # ---------------------------------------------------------------- outages
    def fail_region(self, region: str, now: float) -> int:
        """Scenario outage: all live instances drain, acquisitions are
        refused until ``restore_region``.  Returns instances drained."""
        self.accrue(now)
        self.down_regions.add(region)
        n = 0
        for (m, r, pool), ep in self.endpoints.items():
            if r != region:
                continue
            for p in ep.pending:
                p.cancelled = True
            for inst in list(ep.instances.values()):
                if not inst.draining:
                    ep.drain(inst)
                    n += 1
        return n

    def restore_region(self, region: str, now: float) -> None:
        self.accrue(now)
        self.down_regions.discard(region)

    def placement_state(self, now: float) -> PlacementState:
        """Snapshot for the planner's lead-time pricing: deployments,
        weight locality, warm spot tags, down regions."""
        warm: Dict[Key, int] = {}
        for r, pool in self.spot.items():
            for v in pool:
                if v.last_model is not None \
                        and now - v.since < self.spot_retag_time:
                    k = (v.last_model, r)
                    warm[k] = warm.get(k, 0) + 1
        return PlacementState(
            placed=frozenset(self.deployed),
            weights_local=frozenset(
                (m, r) for r, ms in self.weights_local.items()
                for m in ms),
            warm_spot=warm,
            down_regions=frozenset(self.down_regions))

    # ----------------------------------------------------------------- stats
    def instance_hours(self) -> Dict[Key, float]:
        return {k: v / 3600.0 for k, v in self.instance_seconds.items()}

    def wasted_hours(self) -> Dict[Key, float]:
        return {k: v / 3600.0 for k, v in self.wasted_seconds.items()}

    def spot_hours(self) -> Dict[str, float]:
        return {r: v / 3600.0 for r, v in self.spot_seconds.items()}

    def gpu_dollars(self) -> Dict[Key, float]:
        """Accrued instance-hours priced by the stack's ``CostModel``."""
        return self.cost_model.dollars(self.instance_hours())

    def wasted_dollars(self) -> Dict[Key, float]:
        """Dollars spent on instances still provisioning (cold starts)."""
        return self.cost_model.dollars(self.wasted_hours())
