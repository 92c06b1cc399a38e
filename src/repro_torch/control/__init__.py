"""``repro_torch.control`` — the unified hourly control plane (paper §5–§6).

One package for everything the hourly loop co-optimizes:

- :mod:`repro_torch.control.forecast` — ARIMA fitting (serial
  ``ARIMAForecaster`` + the batched, warm-started
  ``BatchForecastEngine``, one CUDA kernel launch per batch);
- :mod:`repro_torch.control.ilp` — the MILP solver (HiGHS backend + own B&B);
- :mod:`repro_torch.control.provision` — the §5 provisioning program, with
  the ω spill-fraction extension for routing-aware plans;
- :mod:`repro_torch.control.routing` — global region routing
  (``ThresholdRouter``) and the plan-driven ``PlanAwareRouter``;
- :mod:`repro_torch.control.cost` — dollar accounting (``CostModel``);
- :mod:`repro_torch.control.planner` — ``SageServeController``, whose hourly
  output is a single :class:`repro_torch.api.plan.Plan`.

The old ``repro_torch.core.{forecast,ilp,provisioner,routing,controller}``
module paths remain as import shims.  See docs/CONTROL.md.
"""
from repro_torch.control.cost import DEFAULT_DOLLARS_PER_HOUR, CostModel
from repro_torch.control.forecast import (ARIMAForecaster, BatchForecastEngine,
                                    select_order)
from repro_torch.control.ilp import ILPResult, solve_ilp
from repro_torch.control.planner import ControllerConfig, SageServeController
from repro_torch.control.provision import (ProvisionProblem, ProvisionSolution,
                                     solve, solve_with_routing)
from repro_torch.control.routing import (PlanAwareRouter, ThresholdRouter,
                                   pick_endpoint, route_global, route_jsq)

__all__ = [
    "ARIMAForecaster", "BatchForecastEngine", "ControllerConfig",
    "CostModel", "DEFAULT_DOLLARS_PER_HOUR", "ILPResult",
    "PlanAwareRouter", "ProvisionProblem", "ProvisionSolution",
    "SageServeController", "ThresholdRouter", "pick_endpoint",
    "route_global", "route_jsq", "select_order", "solve", "solve_ilp",
    "solve_with_routing",
]
