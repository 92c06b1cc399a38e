"""R4 — determinism hazards.

The control plane must be replayable: same spec + seed -> same plan.
Three hazard classes:

- wall-clock reads (``time.time``, ``datetime.now``) — sim code must use
  sim time; ``time.perf_counter``/``monotonic`` (measurement deltas)
  are allowed;
- module-level RNG (``random.random``, ``np.random.rand``) — draws
  depend on global call order; use seeded ``random.Random`` /
  ``np.random.default_rng`` instances;
- iteration over a ``set``/``frozenset`` — order varies with
  ``PYTHONHASHSEED``, so anything it feeds (ILP variable order, plan
  emission, spot-pool order) varies across processes; wrap in
  ``sorted(...)``.

Measurement-only paths (``train/loop.py``, ``launch/``, benchmarks) are
allowlisted.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.core import Violation
from repro_torch.analysis.project import (ClassInfo, ModuleInfo, ProjectModel,
                                    _is_set_expr, dotted_name,
                                    is_measurement_path)

RULE_ID = "R4"

_WALLCLOCK = {"time": ("time", "time_ns"),
              "datetime": ("now", "utcnow", "today")}
_NP_RANDOM_OK = ("default_rng", "Generator", "SeedSequence", "RandomState",
                 "get_state", "set_state")
_RANDOM_OK = ("Random", "SystemRandom", "getstate", "setstate")


def _module_of(mod: ModuleInfo, root: str) -> Optional[str]:
    return mod.import_aliases.get(root)


def _check_call(mod: ModuleInfo, node: ast.Call) -> Optional[str]:
    dotted = dotted_name(node.func)
    if not dotted or "." not in dotted:
        return None
    root, rest = dotted.split(".", 1)
    target = _module_of(mod, root)
    if target == "time" and rest in _WALLCLOCK["time"]:
        return (f"{dotted}() reads the wall clock — use sim time, or "
                f"time.perf_counter() for measurement deltas")
    if target in ("datetime", "datetime.datetime"):
        leaf = rest.split(".")[-1]
        if leaf in _WALLCLOCK["datetime"]:
            return f"{dotted}() reads the wall clock"
    if target == "random" and rest not in _RANDOM_OK:
        return (f"{dotted}() draws from the global RNG — use a seeded "
                f"random.Random instance")
    if target == "numpy" and rest.startswith("random."):
        leaf = rest.split(".", 1)[1]
        if leaf.split(".")[0] not in _NP_RANDOM_OK:
            return (f"{dotted}() draws from the legacy global numpy RNG — "
                    f"use np.random.default_rng(seed)")
    return None


def _set_iter_violations(mod: ModuleInfo, scope: ast.AST,
                         ci: Optional[ClassInfo]) -> List[Violation]:
    class_sets = ci.set_attrs if ci is not None else set()
    local_sets: Set[str] = set()
    for _ in range(2):  # two passes to propagate simple chains
        for sub in ast.walk(scope):
            target = value = None
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                target, value = sub.targets[0].id, sub.value
            elif isinstance(sub, ast.AnnAssign) \
                    and isinstance(sub.target, ast.Name):
                target, value = sub.target.id, sub.value
            if target and value is not None \
                    and _is_set_expr(value, local_sets, class_sets):
                local_sets.add(target)

    out: List[Violation] = []
    iters = []
    for sub in ast.walk(scope):
        if isinstance(sub, ast.For):
            iters.append(sub.iter)
        elif isinstance(sub, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                              ast.DictComp)):
            iters.extend(g.iter for g in sub.generators)
    for it in iters:
        if _is_set_expr(it, local_sets, class_sets):
            out.append(Violation(
                RULE_ID, mod.display, it.lineno, it.col_offset,
                "iterating a set has PYTHONHASHSEED-dependent order; "
                "wrap in sorted(...) before it feeds plan/ILP state"))
    return out


def check(model: ProjectModel) -> List[Violation]:
    out: List[Violation] = []
    for mod in model.scoped_modules():
        if is_measurement_path(mod.display):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                msg = _check_call(mod, node)
                if msg:
                    out.append(Violation(RULE_ID, mod.display, node.lineno,
                                         node.col_offset, msg))
        # set-iteration: module scope, then each class's methods (so
        # self.<set attr> annotations resolve)
        out.extend(_set_iter_violations(mod, mod.tree, None))
        for ci in mod.classes.values():
            for fi in ci.methods.values():
                out.extend(_set_iter_violations(mod, fi.node, ci))
    # module-scope walk also descends into methods (without class
    # context); identical findings are deduplicated by the runner
    return out
