"""R2 — spec round-trip completeness.

Hand-maintained ``to_dict``/``from_dict`` pairs silently drift when a
dataclass grows a field.  For every dataclass that defines either
method, each declared field must be representable in both directions,
and ``from_dict`` must reject unknown keys (either via
``repro_torch.api.spec.strict_from_dict`` or an inline
``dataclasses.fields``-based check that raises).

The core spec classes (``StackSpec``, ``ExperimentSpec``,
``WorkloadSpec``, ``ScenarioSpec``, ``PlacementPlan``) are additionally
required to provide *both* methods.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.core import Violation
from repro_torch.analysis.project import ClassInfo, ProjectModel, _call_name

RULE_ID = "R2"

REQUIRE_BOTH = frozenset({"StackSpec", "ExperimentSpec", "WorkloadSpec",
                          "ScenarioSpec", "PlacementPlan"})


def _calls_any(node: ast.AST, names: Set[str]) -> bool:
    return any(isinstance(sub, ast.Call) and _call_name(sub.func) in names
               for sub in ast.walk(node))


def _has_raise(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Raise) for sub in ast.walk(node))


def _literal_keys(node: ast.AST) -> Set[str]:
    """String keys visibly handled: dict-literal keys, ``out["k"] = ...``
    stores, ``d["k"]`` / ``d.get("k", ...)`` reads."""
    keys: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Dict):
            for k in sub.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
        elif isinstance(sub, ast.Subscript) \
                and isinstance(sub.slice, ast.Constant) \
                and isinstance(sub.slice.value, str):
            keys.add(sub.slice.value)
        elif isinstance(sub, ast.Call) and _call_name(sub.func) == "get" \
                and sub.args and isinstance(sub.args[0], ast.Constant) \
                and isinstance(sub.args[0].value, str):
            keys.add(sub.args[0].value)
    return keys


def _ctor_keywords(node: ast.AST, cls_name: str) -> Set[str]:
    """Keyword names passed to ``cls(...)`` / ``ClassName(...)``; ``"**"``
    marks a dict-splat (treated as covering everything)."""
    kws: Set[str] = set()
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        fname = _call_name(sub.func)
        if fname not in ("cls", cls_name):
            continue
        for kw in sub.keywords:
            kws.add(kw.arg if kw.arg is not None else "**")
    return kws


def _check_class(model: ProjectModel, ci: ClassInfo) -> List[Violation]:
    out: List[Violation] = []
    to_d = ci.methods.get("to_dict")
    from_d = ci.methods.get("from_dict")
    fields = set(ci.fields)

    if ci.name in REQUIRE_BOTH:
        for mname, m in (("to_dict", to_d), ("from_dict", from_d)):
            if m is None:
                out.append(Violation(
                    RULE_ID, ci.file, ci.lineno, 0,
                    f"{ci.name} is a core spec class but defines no "
                    f"{mname}() — dict round-trip is required"))
    if not fields:
        return out

    if to_d is not None and not _calls_any(to_d.node, {"fields", "asdict"}):
        missing = sorted(fields - _literal_keys(to_d.node))
        if missing:
            out.append(Violation(
                RULE_ID, ci.file, to_d.lineno, 0,
                f"{ci.name}.to_dict() does not emit field(s) "
                f"{', '.join(missing)}"))

    if from_d is not None:
        strict = _calls_any(from_d.node, {"strict_from_dict"}) or (
            _calls_any(from_d.node, {"fields"})
            and _has_raise(from_d.node))
        if not strict:
            out.append(Violation(
                RULE_ID, ci.file, from_d.lineno, 0,
                f"{ci.name}.from_dict() does not reject unknown keys "
                f"(use strict_from_dict or a dataclasses.fields check "
                f"that raises)"))
        complete = (
            _calls_any(from_d.node, {"strict_from_dict"})
            or "**" in _ctor_keywords(from_d.node, ci.name))
        if not complete:
            handled = _ctor_keywords(from_d.node, ci.name) \
                | _literal_keys(from_d.node)
            missing = sorted(fields - handled)
            if missing:
                out.append(Violation(
                    RULE_ID, ci.file, from_d.lineno, 0,
                    f"{ci.name}.from_dict() never reads field(s) "
                    f"{', '.join(missing)}"))
    return out


def check(model: ProjectModel) -> List[Violation]:
    out: List[Violation] = []
    for mod in model.scoped_modules():
        for ci in mod.classes.values():
            if not ci.is_dataclass:
                continue
            if ci.name in REQUIRE_BOTH or "to_dict" in ci.methods \
                    or "from_dict" in ci.methods:
                out.extend(_check_class(model, ci))
    return out
