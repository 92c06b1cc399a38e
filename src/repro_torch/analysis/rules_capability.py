"""R3 — capability-probe integrity.

A typo'd duck-type probe (``getattr(obj, "updat_plan", None)``) silently
no-ops forever.  Three checks:

- every ``hasattr``/``getattr`` probe with a literal attribute name must
  name an attribute that exists *somewhere* in the project (any class
  method/field/assigned attribute, declared capability, or a known
  external attr like ``shape``);
- every ``capability(obj, "name")`` call must name a declared entry in
  ``repro_torch.api.capabilities.CAPABILITIES``;
- every declared capability must be implemented, with compatible arity,
  by at least one class in the project (a declaration nothing provides
  is itself drift).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import Violation
from repro_torch.analysis.project import ProjectModel, _call_name

RULE_ID = "R3"


def _literal_attr(call: ast.Call) -> Optional[str]:
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    return None


def _implemented_with_arity(model: ProjectModel, name: str,
                            arity: int) -> bool:
    for hits in model._classes.values():
        for ci in hits:
            fi = ci.methods.get(name)
            if fi is None:
                continue
            if fi.req_pos <= arity and (arity <= fi.max_pos
                                        or fi.has_vararg):
                return True
    return False


def check(model: ProjectModel) -> List[Violation]:
    out: List[Violation] = []
    for mod in model.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = _call_name(node.func)
            if fname in ("hasattr", "getattr"):
                attr = _literal_attr(node)
                if attr is not None \
                        and not model.has_attr_somewhere(attr):
                    out.append(Violation(
                        RULE_ID, mod.display, node.lineno, node.col_offset,
                        f"{fname}(..., {attr!r}) probes an attribute that "
                        f"exists nowhere in the project — typo'd "
                        f"capability names silently no-op"))
            elif fname == "capability" and model.capabilities:
                attr = _literal_attr(node)
                if attr is not None and attr not in model.capabilities:
                    out.append(Violation(
                        RULE_ID, mod.display, node.lineno, node.col_offset,
                        f"capability(..., {attr!r}) is not declared in "
                        f"CAPABILITIES "
                        f"(declared: {', '.join(sorted(model.capabilities))})"))
    for name in sorted(model.capabilities):
        arity = model.capabilities[name]
        if not _implemented_with_arity(model, name, arity):
            file, line = model.capability_sites.get(name, ("", 1))
            out.append(Violation(
                RULE_ID, file, line, 0,
                f"declared capability {name!r} (arity {arity}) is "
                f"implemented by no class in the project"))
    return out
