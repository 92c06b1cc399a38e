"""R1 — registry/protocol conformance.

Every class registered under a ``repro_torch.api.registry`` kind must
structurally implement that kind's protocol: each protocol method must
exist (directly or via a base class) and accept the protocol's
positional arity.  Registrations whose factory cannot be resolved to a
class statically (loop-registered lambdas) are skipped — this rule is
best-effort by design, never wrong-by-guessing.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis.core import Violation
from repro_torch.analysis.project import ClassInfo, FuncInfo, ProjectModel

RULE_ID = "R1"

#: registry kind -> protocol class in repro_torch/api/protocols.py.  The
#: scheduler protocol is a bare ``__call__`` callable resolved through
#: ``make_order_fn`` indirection — not checkable structurally.
KIND_PROTOCOLS = {
    "router": "Router",
    "scaler": "Scaler",
    "forecaster": "Forecaster",
    "queue": "QueuePolicy",
    "planner": "GlobalPlanner",
}


def _protocol_methods(proto: ClassInfo) -> List[FuncInfo]:
    out = []
    for name, fi in proto.methods.items():
        if name.startswith("_") and name != "__call__":
            continue
        if fi.is_property:
            continue
        out.append(fi)
    return out


def _arity_ok(impl: FuncInfo, proto: FuncInfo) -> bool:
    if impl.req_pos > proto.req_pos:
        return False  # impl demands more args than the protocol passes
    if impl.max_pos < proto.max_pos and not impl.has_vararg:
        return False  # impl can't absorb everything the protocol passes
    if impl.req_kwonly:
        return False  # protocol call sites pass positionally
    return True


def check(model: ProjectModel) -> List[Violation]:
    out: List[Violation] = []
    for reg in model.registrations:
        proto_name: Optional[str] = KIND_PROTOCOLS.get(reg.kind)
        if proto_name is None:
            continue
        proto = model.protocols.get(proto_name)
        if proto is None:
            continue
        if reg.target_class is None:
            continue  # dynamic registration — unresolvable statically
        ci = model.find_class(reg.target_class)
        if ci is None:
            out.append(Violation(
                RULE_ID, reg.file, reg.lineno, 0,
                f"{reg.kind}:{reg.reg_name} factory {reg.factory_name} "
                f"names class {reg.target_class!r}, which is not defined "
                f"anywhere in the project"))
            continue
        for pfi in _protocol_methods(proto):
            impl = model.resolve_method(ci, pfi.name)
            if impl is None:
                out.append(Violation(
                    RULE_ID, reg.file, reg.lineno, 0,
                    f"{reg.kind}:{reg.reg_name} resolves to "
                    f"{ci.name}, which does not implement "
                    f"{proto.name}.{pfi.name}()"))
            elif not _arity_ok(impl, pfi):
                out.append(Violation(
                    RULE_ID, reg.file, reg.lineno, 0,
                    f"{ci.name}.{pfi.name} (line {impl.lineno}) accepts "
                    f"[{impl.req_pos}..{'*' if impl.has_vararg else impl.max_pos}] "
                    f"positional args but protocol {proto.name}.{pfi.name} "
                    f"is called with {proto.max_pos}"))
    return out
