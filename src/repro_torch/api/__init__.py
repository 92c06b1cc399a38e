"""Unified control-plane API: protocols, registry, declarative specs.

The import surface is layered to stay cycle-free: ``registry``,
``protocols``, ``signals`` and ``spec`` load eagerly (core modules
import them to register components); the stack builder — which imports
the simulator and the core built-ins — loads lazily on first access of
``build_stack`` / ``ServingStack`` / ``simulate``, and the experiment
layer (``ExperimentSpec`` / ``run_experiment`` / ``ResultSet``, which
imports the workload generator) likewise on first access.
"""
from repro_torch.api.capabilities import CAPABILITIES, capability
from repro_torch.api.plan import (PlacementAction, PlacementPlan,
                                  PlacementState, Plan, RoutingPlan)
from repro_torch.api.protocols import (Forecaster, GlobalPlanner,
                                       QueuePolicy, RequestLike, Router,
                                       Scaler, Scheduler)
from repro_torch.api.registry import known, register, resolve
from repro_torch.api.signals import BacklogSignal, Signal, UtilizationSignal
from repro_torch.api.spec import (OutageWindow, PolicySpec, ScenarioSpec,
                                  StackSpec)

_LAZY_STACK = ("BuildContext", "ServingStack", "build_stack", "simulate")
_LAZY_EXPERIMENT = ("ExperimentSpec", "ResultSet", "RunResult", "Variant",
                    "derive_seed", "run_experiment")

__all__ = [
    "BacklogSignal", "BuildContext", "CAPABILITIES", "ExperimentSpec",
    "Forecaster", "capability",
    "GlobalPlanner", "OutageWindow", "PlacementAction", "PlacementPlan",
    "PlacementState", "Plan", "PolicySpec", "QueuePolicy", "RequestLike",
    "ResultSet", "Router", "RoutingPlan", "RunResult", "Scaler",
    "ScenarioSpec", "Scheduler", "ServingStack", "Signal", "StackSpec",
    "UtilizationSignal", "Variant", "build_stack", "derive_seed", "known",
    "register", "resolve", "run_experiment", "simulate",
]


def __getattr__(name):
    if name in _LAZY_STACK:
        from repro_torch.api import stack
        return getattr(stack, name)
    if name in _LAZY_EXPERIMENT:
        from repro_torch.api import experiment
        return getattr(experiment, name)
    raise AttributeError(
        f"module 'repro_torch.api' has no attribute {name!r}")
