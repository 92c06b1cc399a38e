"""R7 — cache-key completeness for content-addressed caches.

The amortized control plane (docs/PERF.md) is only correct while its
cache keys stay *complete*: ``problem_fingerprint`` must hash every
field of ``ProvisionProblem``, the batched forecast signature every
config knob ``_fit_arma_core`` reads, and the vector engine's
``_SEG_CACHE`` static key everything its step closes over.  A field
added to one of those dataclasses but not to its digest silently serves
stale plans across a whole sweep.

A function opts into the contract with a marker comment on (or directly
above) its ``def``::

    # reprolint: cache-key=ProvisionProblem
    def problem_fingerprint(problem, ...):

The target is either a dataclass name — every declared field must be
read through the function's first parameter — or the literal
``__init__`` — every ``self.X`` assigned in the enclosing class's
``__init__`` must be read in the marked method.  Fields that are
deliberately *not* part of the key carry an explicit exemption inside
the function (reason required)::

    # reprolint: key-exempt=models -- names are host-side labels; M is keyed

Fires when: a field is neither read nor exempted; an exemption has no
reason; an exemption names an unknown field; an exemption is stale (the
field *is* read); or the marker's target cannot be resolved.  Adding a
field to a covered dataclass therefore fails lint until it is hashed or
deliberately exempted.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import Violation
from repro_torch.analysis.project import ClassInfo, ModuleInfo, ProjectModel

RULE_ID = "R7"

_MARKER_RE = re.compile(
    r"#\s*reprolint:\s*cache-key=(?P<target>[A-Za-z_][A-Za-z0-9_]*)\s*$")
_EXEMPT_RE = re.compile(
    r"#\s*reprolint:\s*key-exempt=(?P<field>[A-Za-z_][A-Za-z0-9_]*)"
    r"(?:\s*--\s*(?P<reason>\S.*))?\s*$")

_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


def _functions(mod: ModuleInfo) -> List[Tuple[ast.AST, Optional[ast.ClassDef]]]:
    """Every function in the module with its enclosing class (if any)."""
    out: List[Tuple[ast.AST, Optional[ast.ClassDef]]] = []

    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC):
                out.append((child, cls))
                walk(child, cls)
            elif isinstance(child, ast.ClassDef):
                walk(child, child)
            else:
                walk(child, cls)

    walk(mod.tree, None)
    return out


def _attach(line: int, on_code_line: bool, funcs) -> Optional[ast.AST]:
    """The function a marker at ``line`` governs: the innermost function
    containing the line (trailing comment), else the next ``def`` below
    it (comment-only line above the def / its decorators)."""
    if on_code_line:
        inner = None
        for fn, _ in funcs:
            if fn.lineno <= line <= (fn.end_lineno or fn.lineno):
                if inner is None or fn.lineno > inner.lineno:
                    inner = fn
        if inner is not None:
            return inner
    below = [fn for fn, _ in funcs if fn.lineno >= line]
    return min(below, key=lambda f: f.lineno) if below else None


def _enclosing_class(fn: ast.AST, funcs) -> Optional[ast.ClassDef]:
    for f, cls in funcs:
        if f is fn:
            return cls
    return None


def _init_assigned_attrs(cls: ast.ClassDef) -> Set[str]:
    """self.X assigned anywhere in ``cls.__init__`` (tuple targets too)."""
    init = next((s for s in cls.body
                 if isinstance(s, _FUNC) and s.name == "__init__"), None)
    if init is None:
        return set()
    attrs: Set[str] = set()

    def targets_of(node):
        if isinstance(node, ast.Assign):
            return node.targets
        if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            return [node.target]
        return []

    for sub in ast.walk(init):
        for t in targets_of(sub):
            for el in ast.walk(t):
                if isinstance(el, ast.Attribute) \
                        and isinstance(el.value, ast.Name) \
                        and el.value.id == "self":
                    attrs.add(el.attr)
    return attrs


def _reads_of(fn: ast.AST, base: str) -> Set[str]:
    """Attributes read (Load) off ``base.<attr>`` inside ``fn``."""
    reads: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Load) \
                and isinstance(sub.value, ast.Name) and sub.value.id == base:
            reads.add(sub.attr)
    return reads


def _first_param(fn: ast.AST, is_method: bool) -> Optional[str]:
    pos = list(fn.args.posonlyargs) + list(fn.args.args)
    if is_method and pos:
        pos = pos[1:]
    return pos[0].arg if pos else None


def _check_marker(mod: ModuleInfo, model: ProjectModel, line: int,
                  target: str, funcs) -> List[Violation]:
    out: List[Violation] = []
    fn = _attach(line, line in mod.source.code_lines, funcs)
    if fn is None:
        return [Violation(RULE_ID, mod.display, line, 0,
                          f"cache-key={target} marker is not attached to "
                          f"any function")]
    cls = _enclosing_class(fn, funcs)

    if target == "__init__":
        if cls is None:
            return [Violation(
                RULE_ID, mod.display, fn.lineno, fn.col_offset,
                f"cache-key=__init__ on module-level {fn.name}() — the "
                f"target only makes sense on a method")]
        required = _init_assigned_attrs(cls)
        reads = _reads_of(fn, "self")
        what = f"{cls.name}.__init__ attribute"
    else:
        ci: Optional[ClassInfo] = model.find_class(target)
        if ci is None:
            return [Violation(
                RULE_ID, mod.display, fn.lineno, fn.col_offset,
                f"cache-key target {target!r} is not a known class")]
        if not ci.is_dataclass:
            return [Violation(
                RULE_ID, mod.display, fn.lineno, fn.col_offset,
                f"cache-key target {target!r} is not a dataclass — only "
                f"declared-field dataclasses are checkable")]
        required = set(ci.fields)
        param = _first_param(fn, cls is not None)
        if param is None:
            return [Violation(
                RULE_ID, mod.display, fn.lineno, fn.col_offset,
                f"cache-key={target} on {fn.name}() which takes no "
                f"parameter to read the fields from")]
        reads = _reads_of(fn, param)
        what = f"{target} field"

    # exemptions live between the marker and the end of the function
    exempt: Dict[str, Tuple[int, Optional[str]]] = {}
    for cline, comment in mod.source.comments:
        if not (line <= cline <= (fn.end_lineno or fn.lineno)):
            continue
        m = _EXEMPT_RE.search(comment)
        if m:
            exempt[m.group("field")] = (cline, m.group("reason"))

    for field, (eline, reason) in sorted(exempt.items(),
                                         key=lambda kv: kv[1][0]):
        if reason is None:
            out.append(Violation(
                RULE_ID, mod.display, eline, 0,
                f"key-exempt={field} is missing its required reason "
                f"(use `# reprolint: key-exempt={field} -- why`)"))
        if field not in required:
            out.append(Violation(
                RULE_ID, mod.display, eline, 0,
                f"key-exempt={field} names no {what}"))
        elif field in reads:
            out.append(Violation(
                RULE_ID, mod.display, eline, 0,
                f"stale key-exempt: {what} '{field}' IS read by "
                f"{fn.name}(); drop the exemption"))

    for field in sorted(required - reads - set(exempt)):
        out.append(Violation(
            RULE_ID, mod.display, fn.lineno, fn.col_offset,
            f"cache-key contract: {what} '{field}' is neither read in "
            f"{fn.name}() nor key-exempted — new fields must be hashed "
            f"or deliberately exempted"))
    return out


def check(model: ProjectModel) -> List[Violation]:
    out: List[Violation] = []
    for mod in model.scoped_modules():
        markers = [(line, m.group("target"))
                   for line, comment in mod.source.comments
                   for m in [_MARKER_RE.search(comment)] if m]
        if not markers:
            continue
        funcs = _functions(mod)
        for line, target in markers:
            out.extend(_check_marker(mod, model, line, target, funcs))
    return out
