"""Unified control-plane API: protocols, registry, declarative specs.

The import surface is layered to stay cycle-free: ``registry``,
``protocols``, ``signals`` and ``spec`` load eagerly (core modules
import them to register components); the stack builder — which imports
the simulator and the core built-ins — loads lazily on first access of
``build_stack`` / ``ServingStack`` / ``simulate``.  The experiment
layer (``ExperimentSpec`` / ``run_experiment``) drives the vector
engine and waits for its port.
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

__all__ = [
    "BacklogSignal", "BuildContext", "CAPABILITIES", "Forecaster",
    "capability",
    "GlobalPlanner", "OutageWindow", "PlacementAction", "PlacementPlan",
    "PlacementState", "Plan", "PolicySpec", "QueuePolicy", "RequestLike",
    "Router", "RoutingPlan", "Scaler",
    "ScenarioSpec", "Scheduler", "ServingStack", "Signal", "StackSpec",
    "UtilizationSignal", "build_stack", "known",
    "register", "resolve", "simulate",
]


def __getattr__(name):
    if name in _LAZY_STACK:
        from repro_torch.api import stack
        return getattr(stack, name)
    raise AttributeError(
        f"module 'repro_torch.api' has no attribute {name!r}")
