"""``build_stack``: the single construction path from a declarative
``StackSpec`` to a runnable ``ServingStack``.

The builder resolves every policy slot through the registry (handing
factories a ``BuildContext`` of models/regions/perf-profiles so e.g.
Chiron can default its offline throughput table and the SageServe
planner its θ), then bundles the components with the simulator wiring.
Examples, benchmarks and tests all construct stacks here — nothing
hand-wires ``SimConfig`` fields any more::

    spec = StackSpec(models=PAPER_MODELS, regions=REGIONS,
                     scaler="lt-ua", planner="sageserve")
    report = build_stack(spec).simulate(trace, name="lt-ua")

Components are stateful; build a fresh stack per simulation run (sweeps
re-call ``build_stack`` per grid point, which is cheap).

``build_stack(spec, device=...)`` names where a stack's forecast fits
run and its vector segments step: the ``sageserve`` planner resolves it
(CUDA unless ``"cpu"``) when it is built, ``simulate_vector`` when it
runs.  The event loop of a stack without a forecaster touches no
device.  The device is not part of ``StackSpec``, so spec hashing is
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch import DeviceLike
from repro_torch.api.capabilities import capability
from repro_torch.api.registry import resolve
from repro_torch.api.spec import StackSpec
from repro_torch.control.cost import CostModel
from repro_torch.sim.metrics import Report
from repro_torch.sim.perfmodel import PROFILES, PerfProfile
from repro_torch.sim.simulator import SimConfig, Simulation
from repro_torch.sim.types import Request


@dataclasses.dataclass(frozen=True)
class BuildContext:
    """What component factories may need beyond their own kwargs."""

    models: Tuple[str, ...]
    regions: Tuple[str, ...]
    profiles: Dict[str, PerfProfile]
    # control-loop knobs factories may key defaults off (e.g. the
    # sageserve planner's seasonal period spans one day of tps_window
    # buckets, capped by what the history lookback actually retains)
    tps_window: float = 60.0
    history_lookback: float = 8 * 86400.0
    # stress scenario (outage windows / region caps): the sageserve
    # planner reads the outage schedule so placement evacuates ahead
    # of known windows
    scenario: Optional[object] = None
    # where forecast fits run (resolved by the component that fits)
    device: DeviceLike = None


@dataclasses.dataclass
class ServingStack:
    """A fully-assembled control plane: resolved policy components plus
    the wiring record the simulator consumes."""

    spec: StackSpec
    scaler: object
    scheduler: object
    router: object
    queue: Optional[object]
    planner: Optional[object]
    profiles: Dict[str, PerfProfile]
    # where forecast fits run and vector segments step (CUDA unless "cpu")
    device: DeviceLike = None

    # ----------------------------------------------------------------- sim
    def sim_config(self) -> SimConfig:
        spec = self.spec
        initial = spec.initial_instances
        if initial is None:
            sizer = capability(self.scaler, "initial_instances")
            initial = sizer() if sizer else 20
        return SimConfig(
            policy=self.scaler,
            scheduler=self.scheduler,
            controller=self.planner,
            queue_manager=self.queue,
            router=self.router,
            siloed=spec.siloed,
            initial_instances=initial,
            siloed_iw=spec.siloed_iw,
            siloed_niw=spec.siloed_niw,
            spot_spare=spec.spot_spare,
            tick=spec.tick,
            sample_every=spec.sample_every,
            qm_signal_thresh=spec.qm_signal_thresh,
            tps_window=spec.tps_window,
            drain_grace=spec.drain_grace,
            retry_base=spec.retry_base,
            retry_cap=spec.retry_cap,
            max_retries=spec.max_retries,
            slo_ttft=dict(spec.slo_ttft),
            history_lookback=spec.history_lookback,
            cost_model=CostModel(alpha=spec.cost_alpha,
                                 rates=dict(spec.cost_rates)),
            scenario=spec.scenario,
            placement=spec.placement,
        )

    def simulate(self, trace: Sequence[Request], name: str = "sim"
                 ) -> Report:
        sim = Simulation(trace, self.sim_config(),
                         models=list(self.spec.models),
                         regions=list(self.spec.regions),
                         profiles=self.profiles, name=name)
        return sim.run()

    def simulate_vector(self, trace, name: str = "sim") -> Report:
        """Run the same stack on the vectorized bucket engine
        (``repro_torch.sim.vector``, docs/PERF.md) on the stack's
        device.  ``trace`` may be a columnar ``Trace`` (preferred — no
        Request materialization) or a Request sequence.  Raises
        ``VectorUnsupported`` when a component has no vector lowering."""
        from repro_torch.sim.vector import VectorSimulation
        sim = VectorSimulation(trace, self.sim_config(),
                               models=list(self.spec.models),
                               regions=list(self.spec.regions),
                               profiles=self.profiles, name=name,
                               device=self.device)
        return sim.run()


def build_stack(spec: StackSpec,
                profiles: Optional[Dict[str, PerfProfile]] = None,
                device: DeviceLike = None) -> ServingStack:
    """Validate the spec and assemble controller, queue manager, scaling
    policy and routing in one call.  ``device``: where forecast fits run
    (CUDA unless ``"cpu"``)."""
    spec.validate()
    profiles = profiles or {m: PROFILES[m] for m in spec.models}
    ctx = BuildContext(tuple(spec.models), tuple(spec.regions),
                       dict(profiles), tps_window=spec.tps_window,
                       history_lookback=spec.history_lookback,
                       scenario=spec.scenario, device=device)
    return ServingStack(
        spec=spec,
        scaler=resolve("scaler", spec.scaler, ctx),
        scheduler=resolve("scheduler", spec.scheduler, ctx),
        router=resolve("router", spec.router, ctx),
        queue=resolve("queue", spec.queue, ctx),
        planner=resolve("planner", spec.planner, ctx),
        profiles=dict(profiles),
        device=device,
    )


def simulate(spec: StackSpec, trace: Sequence[Request], name: str = "sim",
             profiles: Optional[Dict[str, PerfProfile]] = None,
             device: DeviceLike = None) -> Report:
    """Build a fresh stack from ``spec`` and run it over ``trace``."""
    return build_stack(spec, profiles=profiles,
                       device=device).simulate(trace, name=name)
