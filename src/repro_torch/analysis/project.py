"""Shared static model of the project for reprolint rules.

Builds, from ASTs alone, the facts rules need: classes with method
signatures and inheritance, ``@register(kind, name)`` registrations and
the classes their factories construct, ``typing.Protocol`` definitions,
the declared capability table (parsed out of
``repro_torch/api/capabilities.py`` as a dict literal — never imported),
per-module import aliases, and a project-wide attribute namespace for
validating duck-type probes.  A copy of ``repro.analysis.project``.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import SourceFile

#: attrs probed on *external* objects we cannot see statically: numpy /
#: jax array attrs (``shape``/``dtype``), jax tree-path entries
#: (``DictKey.key``, ``SequenceKey.idx``), bound-method introspection
#: (``__self__``).  Kept deliberately tiny — anything else must exist in
#: the project or be suppressed with a reason.
EXTERNAL_ATTRS = frozenset({"shape", "dtype", "key", "idx", "__self__"})


@dataclasses.dataclass
class FuncInfo:
    name: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    lineno: int
    req_pos: int          # required positional args (self/cls excluded)
    max_pos: int          # max positional args (self/cls excluded)
    has_vararg: bool
    req_kwonly: Tuple[str, ...]
    is_property: bool
    is_staticmethod: bool
    is_classmethod: bool


@dataclasses.dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    lineno: int
    file: str
    bases: Tuple[str, ...]
    methods: Dict[str, FuncInfo]
    class_attrs: Set[str]
    fields: List[str]            # dataclass fields, declaration order
    is_dataclass: bool
    is_protocol: bool
    self_attrs: Set[str]
    set_attrs: Set[str]          # self.X known to hold a set/frozenset
    defaultdict_attrs: Set[str]  # self.X known to hold a defaultdict


@dataclasses.dataclass
class Registration:
    kind: str
    reg_name: str
    file: str
    lineno: int
    target_class: Optional[str]   # resolved class name, None if dynamic
    factory_name: str


@dataclasses.dataclass
class ModuleInfo:
    source: SourceFile
    classes: Dict[str, ClassInfo]
    functions: Dict[str, FuncInfo]
    import_aliases: Dict[str, str]   # local name -> dotted module
    registrations: List[Registration]

    @property
    def display(self) -> str:
        return self.source.display

    @property
    def tree(self) -> ast.Module:
        return self.source.tree

    def imports(self, dotted_prefix: str) -> bool:
        return any(mod == dotted_prefix or mod.startswith(dotted_prefix + ".")
                   for mod in self.import_aliases.values())


def _decorator_name(dec: ast.AST) -> str:
    if isinstance(dec, ast.Call):
        dec = dec.func
    if isinstance(dec, ast.Attribute):
        return dec.attr
    if isinstance(dec, ast.Name):
        return dec.id
    return ""


def _func_info(node, is_method: bool) -> FuncInfo:
    decs = {_decorator_name(d) for d in node.decorator_list}
    is_static = "staticmethod" in decs
    is_class = "classmethod" in decs
    a = node.args
    pos = list(a.posonlyargs) + list(a.args)
    if is_method and not is_static and pos:
        pos = pos[1:]  # drop self / cls
    n_defaults = len(a.defaults)
    req = max(0, len(pos) - n_defaults)
    req_kwonly = tuple(kw.arg for kw, d in zip(a.kwonlyargs, a.kw_defaults)
                       if d is None)
    return FuncInfo(
        name=node.name, node=node, lineno=node.lineno,
        req_pos=req, max_pos=len(pos), has_vararg=a.vararg is not None,
        req_kwonly=req_kwonly,
        is_property="property" in decs or "cached_property" in decs,
        is_staticmethod=is_static, is_classmethod=is_class)


def _base_name(b: ast.AST) -> str:
    if isinstance(b, ast.Attribute):
        return b.attr
    if isinstance(b, ast.Name):
        return b.id
    if isinstance(b, ast.Subscript):  # Protocol[...], Generic[T]
        return _base_name(b.value)
    return ""


def _is_set_expr(node: ast.AST, local_sets: Set[str],
                 class_set_attrs: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Name) and node.id in local_sets:
        return True
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self" and node.attr in class_set_attrs:
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitOr,
                                                            ast.BitAnd,
                                                            ast.Sub)):
        return _is_set_expr(node.left, local_sets, class_set_attrs) \
            or _is_set_expr(node.right, local_sets, class_set_attrs)
    return False


def _ann_is_set(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    return _base_name(ann) in ("Set", "set", "FrozenSet", "frozenset")


def _call_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _class_info(node: ast.ClassDef, display: str) -> ClassInfo:
    decs = {_decorator_name(d) for d in node.decorator_list}
    bases = tuple(filter(None, (_base_name(b) for b in node.bases)))
    methods: Dict[str, FuncInfo] = {}
    class_attrs: Set[str] = set()
    fields: List[str] = []
    slots: Set[str] = set()
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[stmt.name] = _func_info(stmt, is_method=True)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                            ast.Name):
            if "ClassVar" in ast.dump(stmt.annotation):
                class_attrs.add(stmt.target.id)
            else:
                fields.append(stmt.target.id)
                class_attrs.add(stmt.target.id)
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    class_attrs.add(t.id)
                    if t.id == "__slots__":
                        for el in ast.walk(stmt.value):
                            if isinstance(el, ast.Constant) \
                                    and isinstance(el.value, str):
                                slots.add(el.value)
    class_attrs |= slots

    self_attrs: Set[str] = set(slots)
    set_attrs: Set[str] = set()
    dd_attrs: Set[str] = set()
    for fi in methods.values():
        for sub in ast.walk(fi.node):
            target = value = ann = None
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                target, value = sub.targets[0], sub.value
            elif isinstance(sub, ast.AnnAssign):
                target, value, ann = sub.target, sub.value, sub.annotation
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            self_attrs.add(target.attr)
            if _ann_is_set(ann) or (value is not None
                                    and _is_set_expr(value, set(), set())):
                set_attrs.add(target.attr)
            if isinstance(value, ast.Call) \
                    and _call_name(value.func) == "defaultdict":
                dd_attrs.add(target.attr)

    return ClassInfo(
        name=node.name, node=node, lineno=node.lineno, file=display,
        bases=bases, methods=methods, class_attrs=class_attrs,
        fields=fields, is_dataclass="dataclass" in decs,
        is_protocol="Protocol" in bases, self_attrs=self_attrs,
        set_attrs=set_attrs, defaultdict_attrs=dd_attrs)


def _return_class(node, module_classes: Set[str]) -> Optional[str]:
    """Class a registered factory constructs: prefer the return
    annotation, else a unique ``return ClassName(...)`` statement."""
    ann = node.returns
    if ann is not None:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value
        name = _base_name(ann)
        if name and name not in ("None", "Optional", "Any"):
            return name
    found: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Return) and isinstance(sub.value, ast.Call) \
                and isinstance(sub.value.func, ast.Name) \
                and sub.value.func.id in module_classes:
            found.add(sub.value.func.id)
    if len(found) == 1:
        return found.pop()
    return None


def _collect_module(sf: SourceFile) -> ModuleInfo:
    classes: Dict[str, ClassInfo] = {}
    functions: Dict[str, FuncInfo] = {}
    aliases: Dict[str, str] = {}
    regs: List[Registration] = []

    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                aliases[al.asname or al.name.split(".")[0]] = al.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for al in node.names:
                aliases[al.asname or al.name] = f"{node.module}.{al.name}"
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = _class_info(node, sf.display)

    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions[node.name] = _func_info(node, is_method=False)

    module_class_names = set(classes)
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            continue
        for dec in node.decorator_list:
            if not (isinstance(dec, ast.Call)
                    and _call_name(dec.func) == "register"
                    and len(dec.args) >= 2
                    and all(isinstance(a, ast.Constant)
                            and isinstance(a.value, str)
                            for a in dec.args[:2])):
                continue
            kind, reg_name = dec.args[0].value, dec.args[1].value
            if isinstance(node, ast.ClassDef):
                target: Optional[str] = node.name
            else:
                target = _return_class(node, module_class_names)
            regs.append(Registration(
                kind=kind, reg_name=reg_name, file=sf.display,
                lineno=dec.lineno, target_class=target,
                factory_name=node.name))

    return ModuleInfo(source=sf, classes=classes, functions=functions,
                      import_aliases=aliases, registrations=regs)


def dotted_name(node: ast.AST) -> str:
    """``np.random.rand`` for a Name/Attribute chain, else ``""``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


#: paths exempt from determinism/host-sync rules: measurement-only code
#: where wall-clock reads and host syncs are the point.  The trace tier
#: itself qualifies — it deliberately re-jits and lowers the hot paths
#: to inspect them.
_MEASUREMENT_MARKERS = ("train/loop.py", "launch/", "benchmarks/",
                        "analysis/trace.py")


def is_measurement_path(display: str) -> bool:
    norm = display.replace("\\", "/")
    return any(m in norm for m in _MEASUREMENT_MARKERS)


class ProjectModel:
    """All parsed modules plus cross-module lookup tables."""

    def __init__(self, sources: Sequence[SourceFile], in_scope: Set[str]):
        self.sources = list(sources)
        self.in_scope = set(in_scope)
        self.modules: List[ModuleInfo] = [_collect_module(sf)
                                          for sf in sources]
        self._classes: Dict[str, List[ClassInfo]] = {}
        for mod in self.modules:
            for ci in mod.classes.values():
                self._classes.setdefault(ci.name, []).append(ci)
        self.registrations: List[Registration] = [
            r for mod in self.modules for r in mod.registrations]
        self.protocols: Dict[str, ClassInfo] = {
            ci.name: ci for mod in self.modules
            for ci in mod.classes.values() if ci.is_protocol}
        self.capability_sites: Dict[str, Tuple[str, int]] = {}
        self.capabilities: Dict[str, int] = self._parse_capabilities()
        self.attr_namespace: Set[str] = self._build_namespace()

    # ------------------------------------------------------------ lookups
    def scoped_modules(self) -> List[ModuleInfo]:
        return [m for m in self.modules if m.display in self.in_scope]

    def find_class(self, name: str) -> Optional[ClassInfo]:
        hits = self._classes.get(name)
        return hits[0] if hits else None

    def resolve_method(self, ci: ClassInfo, name: str,
                       _depth: int = 0) -> Optional[FuncInfo]:
        """Look up a method on ``ci`` or (by name) its base classes."""
        if name in ci.methods:
            return ci.methods[name]
        if _depth > 8:
            return None
        for base in ci.bases:
            bci = self.find_class(base)
            if bci is not None and bci is not ci:
                fi = self.resolve_method(bci, name, _depth + 1)
                if fi is not None:
                    return fi
        return None

    def has_attr_somewhere(self, name: str) -> bool:
        return name in self.attr_namespace

    # ---------------------------------------------------------- construction
    def _parse_capabilities(self) -> Dict[str, int]:
        for mod in self.modules:
            if not mod.display.endswith("capabilities.py"):
                continue
            for node in mod.tree.body:
                targets = []
                value = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign):
                    targets, value = [node.target], node.value
                if not any(isinstance(t, ast.Name)
                           and t.id == "CAPABILITIES" for t in targets):
                    continue
                if isinstance(value, ast.Dict):
                    out: Dict[str, int] = {}
                    for k, v in zip(value.keys, value.values):
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str) \
                                and isinstance(v, ast.Constant) \
                                and isinstance(v.value, int):
                            out[k.value] = v.value
                            self.capability_sites[k.value] = (mod.display,
                                                              k.lineno)
                    return out
        return {}

    def _build_namespace(self) -> Set[str]:
        ns: Set[str] = set(EXTERNAL_ATTRS)
        for mod in self.modules:
            ns.update(mod.functions)
            for ci in mod.classes.values():
                ns.update(ci.methods)
                ns.update(ci.class_attrs)
                ns.update(ci.self_attrs)
                ns.update(ci.fields)
            # any attribute ever assigned on any object (module-level
            # singletons, thread-locals, monkey-patched fields, ...)
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, (ast.Store, ast.Del)):
                    ns.add(node.attr)
        ns.update(self.capabilities)
        return ns
