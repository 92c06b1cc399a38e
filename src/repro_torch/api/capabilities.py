"""Declared duck-typed capabilities and the single probe choke point.

The simulator and control plane extend the core protocols with a small
set of *optional* capabilities (e.g. a router that understands routing
plans exposes ``update_plan``).  Historically each call site probed with
an ad-hoc ``getattr(obj, "name", None)``; a typo'd name silently
no-opped.  Every optional capability is now declared here with its
positional arity, and call sites go through :func:`capability`, which

- raises ``KeyError`` at the call site for a capability name that was
  never declared (typos fail loudly, and ``reprolint`` R3 checks the
  name statically), and
- validates, once per ``(type, name)`` pair, that the implementation
  accepts the declared number of positional arguments, raising
  ``TypeError`` on an arity mismatch instead of failing mid-simulation.

This module must stay dependency-light (stdlib only): it is imported
eagerly by ``repro_torch.api`` and by the static-analysis suite's fixtures.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Tuple

#: capability name -> number of positional arguments the *caller* passes
#: (``self`` excluded).  reprolint parses this dict literal statically;
#: keep it a plain ``{"name": int}`` literal.
CAPABILITIES: Dict[str, int] = {
    # router extensions (sim/simulator.py)
    "home_threshold": 0,      # () -> float: home-region spill threshold
    "route_request": 3,       # (request, region_utils, preference) -> region
    "update_plan": 2,         # (plan, now): accept a RoutingPlan
    # scaler extensions
    "wants_request_view": 4,  # (model, region, pool, now) -> bool
    "initial_instances": 0,   # () -> int: per-key warm-start count
    # planner extensions
    "set_placement_state": 1,  # (state): observe actuated placement
    "forecast_spec": 0,       # () -> tuple | None: fleet-batchable fit cfg
    "plan_fitted": 5,         # (now, instances, history, niw, fitted) -> Plan
}

_validated: Dict[Tuple[type, str], Optional[str]] = {}


def capability(obj: object, name: str) -> Optional[Callable]:
    """Return ``obj``'s implementation of a declared capability.

    Returns the bound callable, or ``None`` when ``obj`` does not
    provide the capability.  Raises ``KeyError`` for an undeclared
    capability name and ``TypeError`` when the implementation cannot
    accept the declared positional arity.
    """
    try:
        arity = CAPABILITIES[name]
    except KeyError:
        raise KeyError(
            f"undeclared capability {name!r}; declared capabilities: "
            f"{sorted(CAPABILITIES)}") from None
    fn = getattr(obj, name, None)
    if fn is None or not callable(fn):
        return None
    key = (type(obj), name)
    error = _validated.get(key, "")
    if error == "":  # not yet validated for this type
        error = _arity_error(fn, name, arity)
        _validated[key] = error
    if error is not None:
        raise TypeError(error)
    return fn


def _arity_error(fn: Callable, name: str, arity: int) -> Optional[str]:
    """None if ``fn`` accepts ``arity`` positional args, else a message."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # builtins / C callables: trust them
        return None
    try:
        sig.bind(*(object() for _ in range(arity)))
    except TypeError:
        return (f"{type(fn.__self__).__name__ if hasattr(fn, '__self__') else fn!r}"
                f".{name} has signature {sig} but the {name!r} capability "
                f"is called with {arity} positional argument(s)")
    return None
