"""R5 — read-path mutation of a defaultdict.

``defaultdict.__getitem__`` inserts the default on a miss, so a *read*
accessor that subscripts a ``defaultdict`` attribute mutates state: the
first ``depth(model)`` call for an unknown model plants an empty deque,
changing subsequent iteration and memory behaviour.  Read accessors —
methods named ``depth``/``get*``/``backlog*`` and property getters —
must use ``.get(...)`` instead of ``[...]`` on attributes assigned a
``defaultdict``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import Violation
from repro_torch.analysis.project import FuncInfo, ProjectModel

RULE_ID = "R5"


def _is_read_accessor(fi: FuncInfo) -> bool:
    return (fi.is_property or fi.name == "depth"
            or fi.name.startswith("get") or fi.name.startswith("backlog"))


def check(model: ProjectModel) -> List[Violation]:
    out: List[Violation] = []
    for mod in model.scoped_modules():
        for ci in mod.classes.values():
            if not ci.defaultdict_attrs:
                continue
            for fi in ci.methods.values():
                if not _is_read_accessor(fi):
                    continue
                for sub in ast.walk(fi.node):
                    if isinstance(sub, ast.Subscript) \
                            and isinstance(sub.ctx, ast.Load) \
                            and isinstance(sub.value, ast.Attribute) \
                            and isinstance(sub.value.value, ast.Name) \
                            and sub.value.value.id == "self" \
                            and sub.value.attr in ci.defaultdict_attrs:
                        out.append(Violation(
                            RULE_ID, mod.display, sub.lineno,
                            sub.col_offset,
                            f"{ci.name}.{fi.name} reads "
                            f"self.{sub.value.attr}[...] — defaultdict "
                            f"subscript inserts missing keys on read; "
                            f"use .get(...)"))
    return out
