"""R8 — torch/CUDA hazards (the port's counterpart of the reference's R6).

Three device hazards in modules that import torch:

- a host sync inside a ``for``/``while`` loop: ``.item()``, ``.cpu()``,
  ``torch.cuda.synchronize()``, or ``float(...)``/``int(...)`` around a
  ``torch.`` call — each waits for the device and copies to the host
  once per iteration; keep the loop's values on the device and sync
  once after it;
- ``torch.compile``, ``torch.jit.script`` or ``torch.cuda.CUDAGraph``
  referenced inside a function body — a fresh compile or capture per
  call; build it once at module level or cache it (``self.X = ...`` in
  a body is the cache-once idiom and is exempt);
- a kernel library loaded per call: ``_build.load(...)`` or
  ``ctypes.CDLL(...)`` in a function with no ``functools.lru_cache`` /
  ``functools.cache`` decorator.  ``kernels/_build.py``'s ``load`` is
  exempt: its ``_LIBS`` dict is itself the cache.

Measurement-only paths (``train/loop.py``, ``launch/``,
``analysis/trace.py``, benchmarks) are allowlisted: they sync on
purpose.  The rule has its own id because the reference's R6 also runs
over the port's files and would report an R6 suppression here as stale.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.core import Violation
from repro_torch.analysis.project import (ModuleInfo, ProjectModel,
                                          _decorator_name, dotted_name,
                                          is_measurement_path)

RULE_ID = "R8"

#: compiles and graph captures that must not be made once per call
_CAPTURES = ("torch.compile", "torch.jit.script", "torch.cuda.CUDAGraph")
#: calls that load a kernel library
_LOADERS = ("_build.load", "ctypes.CDLL")
_CACHE_DECORATORS = ("lru_cache", "cache")
#: (file suffix, function) that own a cache of loaded libraries
_CACHE_OWNERS = (("kernels/_build.py", "load"),)

_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


def _torch_aliases(mod: ModuleInfo) -> Dict[str, str]:
    """local name -> dotted torch module or attribute it stands for."""
    return {local: target for local, target in mod.import_aliases.items()
            if target == "torch" or target.startswith("torch.")}


def _resolved(node: ast.AST, aliases: Dict[str, str]) -> str:
    """``torch.cuda.synchronize`` for ``cuda.synchronize`` after
    ``from torch import cuda``; the dotted name itself otherwise."""
    dotted = dotted_name(node)
    if not dotted:
        return ""
    root, _, rest = dotted.partition(".")
    if root in aliases:
        return aliases[root] + ("." + rest if rest else "")
    return dotted


def _host_sync_violations(mod: ModuleInfo,
                          aliases: Dict[str, str]) -> List[Violation]:
    out: List[Violation] = []
    for loop in ast.walk(mod.tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        for sub in ast.walk(loop):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if isinstance(func, ast.Attribute) and not sub.args \
                    and func.attr in ("item", "cpu"):
                out.append(Violation(
                    RULE_ID, mod.display, sub.lineno, sub.col_offset,
                    f".{func.attr}() inside a loop forces a device->host "
                    f"sync per iteration; keep the values on the device "
                    f"and sync once"))
            elif _resolved(func, aliases) == "torch.cuda.synchronize":
                out.append(Violation(
                    RULE_ID, mod.display, sub.lineno, sub.col_offset,
                    "torch.cuda.synchronize() inside a loop waits for the "
                    "device every iteration"))
            elif isinstance(func, ast.Name) and func.id in ("float", "int") \
                    and sub.args and isinstance(sub.args[0], ast.Call):
                inner = _resolved(sub.args[0].func, aliases)
                if inner.startswith("torch."):
                    out.append(Violation(
                        RULE_ID, mod.display, sub.lineno, sub.col_offset,
                        f"{func.id}({inner}(...)) inside a loop forces a "
                        f"device->host sync per iteration"))
    return out


def _capture_in_function_violations(mod: ModuleInfo,
                                    aliases: Dict[str, str]
                                    ) -> List[Violation]:
    out: List[Violation] = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, _FUNC):
            continue
        # `self._graph = torch.cuda.CUDAGraph()` in a body is the
        # cache-once idiom (one per instance) — exempt attr-target assigns
        cached = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) \
                    and any(isinstance(t, ast.Attribute)
                            for t in sub.targets):
                cached.update(id(n) for n in ast.walk(sub.value))
        for stmt in fn.body:  # body only — decorators are fine
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Attribute) \
                        and isinstance(sub.ctx, ast.Load) \
                        and id(sub) not in cached:
                    name = _resolved(sub, aliases)
                    if name in _CAPTURES:
                        out.append(Violation(
                            RULE_ID, mod.display, sub.lineno,
                            sub.col_offset,
                            f"{name} referenced inside {fn.name}() builds "
                            f"a fresh compile or graph per call; build it "
                            f"once at module level or cache it"))
    return out


def _enclosing_functions(tree: ast.AST) -> Dict[int, ast.AST]:
    """id(call) -> the innermost function that contains it."""
    out: Dict[int, ast.AST] = {}

    def walk(node: ast.AST, fn: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            inner = child if isinstance(child, _FUNC) else fn
            if isinstance(child, ast.Call) and fn is not None:
                out[id(child)] = fn
            walk(child, inner)

    walk(tree, None)
    return out


def _loader_violations(mod: ModuleInfo) -> List[Violation]:
    norm = mod.display.replace("\\", "/")
    owners = {name for suffix, name in _CACHE_OWNERS
              if norm.endswith(suffix)}
    enclosing = _enclosing_functions(mod.tree)
    out: List[Violation] = []
    for sub in ast.walk(mod.tree):
        if not isinstance(sub, ast.Call):
            continue
        dotted = dotted_name(sub.func)
        if not any(dotted == n or dotted.endswith("." + n)
                   for n in _LOADERS):
            continue
        fn = enclosing.get(id(sub))
        if fn is None or fn.name in owners:
            continue
        if any(_decorator_name(d) in _CACHE_DECORATORS
               for d in fn.decorator_list):
            continue
        out.append(Violation(
            RULE_ID, mod.display, sub.lineno, sub.col_offset,
            f"{dotted}(...) in {fn.name}() loads the kernel library on "
            f"every call; decorate {fn.name}() with functools.lru_cache "
            f"or load once at module level"))
    return out


def check(model: ProjectModel) -> List[Violation]:
    out: List[Violation] = []
    for mod in model.scoped_modules():
        if is_measurement_path(mod.display):
            continue
        aliases = _torch_aliases(mod)
        if not aliases:
            continue
        out.extend(_host_sync_violations(mod, aliases))
        out.extend(_capture_in_function_violations(mod, aliases))
        out.extend(_loader_violations(mod))
    return out
