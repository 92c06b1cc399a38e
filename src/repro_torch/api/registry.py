"""String-keyed component registry for the SageServe control plane.

Every pluggable component kind (router, scaler, forecaster, scheduler,
queue, planner) has a namespace of named factories::

    @register("scaler", "chiron")
    def _make_chiron(ctx, **kwargs): ...

    scaler = resolve("scaler", "chiron", ctx)
    scaler = resolve("scaler", PolicySpec("lt-ua", {"up": 0.8}), ctx)

A factory takes a ``BuildContext`` (models, regions, perf profiles; may
be ``None`` for context-free components) plus the spec kwargs and
returns the built component.  ``resolve`` passes pre-built objects
through untouched, so call sites accept "name, spec, or instance"
uniformly.

Registration happens at import of the defining module; ``resolve``
imports the built-in component modules on first use so callers never
need to pre-import them.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Mapping, Tuple

KINDS = ("router", "scaler", "forecaster", "scheduler", "queue", "planner")

_REGISTRY: Dict[str, Dict[str, Callable]] = {k: {} for k in KINDS}

# Modules whose import registers the built-in components of each kind.
# Only the schedulers are ported so far; the other kinds' modules join
# this tuple as they are ported.
_BUILTIN_MODULES = (
    "repro_torch.core.scheduling",
)
_builtins_loaded = False


def _ensure_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)
    # only after every import succeeds — a failed import must surface
    # again on the next call, not leave the registry half-populated
    _builtins_loaded = True


def register(kind: str, name: str) -> Callable[[Callable], Callable]:
    """Decorator: publish ``factory(ctx, **kwargs)`` under (kind, name)."""
    if kind not in _REGISTRY:
        raise KeyError(f"unknown component kind {kind!r}; "
                       f"kinds are {KINDS}")

    def deco(factory: Callable) -> Callable:
        _REGISTRY[kind][name.lower()] = factory
        return factory

    return deco


def known(kind: str) -> Tuple[str, ...]:
    """Registered names for a kind (built-ins included)."""
    _ensure_builtins()
    if kind not in _REGISTRY:
        raise KeyError(f"unknown component kind {kind!r}; "
                       f"kinds are {KINDS}")
    return tuple(sorted(_REGISTRY[kind]))


def _lookup(kind: str, name: str) -> Callable:
    _ensure_builtins()
    if kind not in _REGISTRY:
        raise KeyError(f"unknown component kind {kind!r}; "
                       f"kinds are {KINDS}")
    try:
        return _REGISTRY[kind][name.lower()]
    except KeyError:
        raise KeyError(
            f"no {kind} registered under {name!r}; known {kind}s: "
            f"{', '.join(sorted(_REGISTRY[kind])) or '(none)'}") from None


def resolve(kind: str, spec, ctx=None):
    """Build the component a spec names.

    ``spec`` may be a name string, anything with ``.name``/``.kwargs``
    (a ``PolicySpec``), a ``{"name": ..., "kwargs": {...}}`` mapping, or
    an already-built component (returned as-is).
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        name, kwargs = spec, {}
    elif hasattr(spec, "name") and hasattr(spec, "kwargs"):
        name, kwargs = spec.name, dict(spec.kwargs)
    elif isinstance(spec, Mapping):
        name = spec["name"]
        kwargs = dict(spec.get("kwargs", {}))
    else:
        return spec  # pre-built component
    return _lookup(kind, name)(ctx, **kwargs)
