"""Integer Linear Program solver: branch-and-bound over LP relaxations.

Own best-first B&B with HiGHS (``scipy.optimize.linprog``) solving node
relaxations; suits the provisioning problems of §5 (tens–hundreds of
integer vars).  The test-suite cross-checks solutions against
``scipy.optimize.milp`` on random instances.

``ILPResult.gap`` is the *relative* optimality gap
``(incumbent - bound) / max(1, |incumbent|)`` for both backends, so
bnb and milp runs are directly comparable (milp's own stopping rule is
``mip_rel_gap``, and the bnb gap used to be absolute).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, linprog, milp


def _as_matrix(A):
    if A is None or sp.issparse(A):
        return A
    return np.asarray(A, float)


def _rel_gap(incumbent: float, bound: float) -> float:
    if not math.isfinite(incumbent):
        return math.inf
    return max(0.0, incumbent - bound) / max(1.0, abs(incumbent))


def _solve_milp(c, A_ub, b_ub, A_eq, b_eq, bounds, integrality,
                time_limit: float = 60.0, mip_rel_gap: float = 1e-3
                ) -> "ILPResult":
    n = c.shape[0]
    cons = []
    if A_ub is not None:
        cons.append(LinearConstraint(_as_matrix(A_ub), -np.inf,
                                     np.asarray(b_ub, float)))
    if A_eq is not None:
        cons.append(LinearConstraint(_as_matrix(A_eq),
                                     np.asarray(b_eq, float),
                                     np.asarray(b_eq, float)))
    lo = np.array([(-np.inf if b[0] is None else b[0]) for b in bounds])
    hi = np.array([(np.inf if b[1] is None else b[1]) for b in bounds])
    res = milp(c, constraints=cons, bounds=Bounds(lo, hi),
               integrality=integrality.astype(int),
               options={"time_limit": time_limit,
                        "mip_rel_gap": mip_rel_gap})
    if res.status != 0 or res.x is None:
        return ILPResult(np.zeros(n), math.inf, "infeasible", 1, math.inf)
    x = np.where(integrality, np.round(res.x), res.x)
    obj = float(c @ x)
    # HiGHS reports its own bound; fall back to gap 0 when absent
    bound = getattr(res, "mip_dual_bound", None)  # reprolint: disable=R3 -- scipy OptimizeResult attr, set only by the HiGHS MIP path; external type, not a project capability
    gap = _rel_gap(obj, bound) if bound is not None else 0.0
    status = "optimal" if gap <= max(mip_rel_gap, 1e-9) else "feasible"
    return ILPResult(x, obj, status, 1, gap)


def _warm_feasible(x, c, A_ub, b_ub, A_eq, b_eq, bounds, integrality,
                   tol: float) -> bool:
    """Is a warm-start point feasible (bounds, integrality, rows)?"""
    if not np.all(np.isfinite(x)) or x.shape != c.shape:
        return False
    if np.any(np.abs(x - np.round(x))[integrality] > tol):
        return False
    for v, (lo, hi) in enumerate(bounds):
        if lo is not None and x[v] < lo - tol:
            return False
        if hi is not None and x[v] > hi + tol:
            return False
    if A_ub is not None and np.any(
            _as_matrix(A_ub) @ x > np.asarray(b_ub, float) + tol):
        return False
    if A_eq is not None and np.any(
            np.abs(_as_matrix(A_eq) @ x - np.asarray(b_eq, float)) > tol):
        return False
    return True


@dataclasses.dataclass
class ILPResult:
    x: np.ndarray
    objective: float
    status: str            # optimal | feasible | infeasible
    nodes: int
    gap: float             # relative optimality gap


def solve_ilp(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, bounds=None,
              integrality: Optional[np.ndarray] = None,
              max_nodes: int = 2000, tol: float = 1e-6,
              backend: str = "milp", time_limit: float = 60.0,
              mip_rel_gap: float = 1e-3,
              x0: Optional[np.ndarray] = None) -> ILPResult:
    """Minimize c @ x subject to A_ub x <= b_ub, A_eq x = b_eq, bounds.

    integrality: bool mask per var (default: all integer).
    backend: "milp" (HiGHS MIP) or "bnb" (own branch-and-bound over
    linprog relaxations; cross-checked against milp in the tests).
    x0: optional warm-start point (e.g. the previous hour's solution).
    The "bnb" backend seeds it as the initial incumbent after a
    feasibility check, pruning every node whose relaxation cannot beat
    it — the objective value returned is unchanged, but among multiple
    optima the warm incumbent may be the one kept.  The "milp" backend
    ignores it (scipy's HiGHS wrapper exposes no warm-start API).
    """
    c = np.asarray(c, float)
    n = c.shape[0]
    if integrality is None:
        integrality = np.ones(n, bool)
    else:
        integrality = np.asarray(integrality, bool)
    if bounds is None:
        bounds = [(0, None)] * n

    if backend == "milp":
        return _solve_milp(c, A_ub, b_ub, A_eq, b_eq, bounds, integrality,
                           time_limit=time_limit, mip_rel_gap=mip_rel_gap)

    def relax(bnds):
        r = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                    bounds=bnds, method="highs")
        return r

    def frac_var(x):
        f = np.abs(x - np.round(x))
        f = np.where(integrality, f, 0.0)
        i = int(np.argmax(f))
        return (i, f[i]) if f[i] > tol else (None, 0.0)

    root = relax(bounds)
    if root.status != 0:
        return ILPResult(np.zeros(n), math.inf, "infeasible", 1, math.inf)

    # early exit: the root relaxation already integral is the optimum —
    # no need to run it through the node machinery
    i0, _ = frac_var(root.x)
    if i0 is None:
        x = np.round(np.where(integrality, np.round(root.x), root.x), 9)
        return ILPResult(x, float(root.fun), "optimal", 1, 0.0)

    best_x, best_obj = None, math.inf
    if x0 is not None:
        xw = np.asarray(x0, float)
        if _warm_feasible(xw, c, A_ub, b_ub, A_eq, b_eq, bounds,
                          integrality, tol):
            best_x = np.round(np.where(integrality, np.round(xw), xw), 9)
            best_obj = float(c @ best_x)
    counter = itertools.count()
    heap = [(root.fun, next(counter), bounds, root)]
    nodes = 0
    while heap and nodes < max_nodes:
        lb, _, bnds, res = heapq.heappop(heap)
        if lb >= best_obj - tol:
            continue
        nodes += 1
        i, f = frac_var(res.x)
        if i is None:  # integral solution
            if res.fun < best_obj:
                best_obj, best_x = res.fun, np.round(
                    np.where(integrality, np.round(res.x), res.x), 9)
            continue
        lo, hi = bnds[i]
        xi = res.x[i]
        for newb in (((lo, math.floor(xi)), "dn"),
                     ((math.ceil(xi), hi), "up")):
            (nlo, nhi), _ = newb
            if nhi is not None and nlo is not None and nlo > nhi:
                continue
            nb = list(bnds)
            nb[i] = (nlo, nhi)
            r = relax(nb)
            if r.status == 0 and r.fun < best_obj - tol:
                heapq.heappush(heap, (r.fun, next(counter), nb, r))

    if best_x is None:
        # fall back: round the root relaxation and repair bounds
        xr = np.where(integrality, np.round(root.x), root.x)
        return ILPResult(xr, float(c @ xr), "feasible", nodes, math.inf)
    gap = (0.0 if not heap
           else _rel_gap(best_obj, min(h[0] for h in heap)))
    status = "optimal" if (not heap or gap <= tol) and nodes < max_nodes \
        else "feasible"
    return ILPResult(best_x, float(best_obj), status, nodes, gap)
