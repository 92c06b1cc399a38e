"""§5 optimization problem: optimal instance-count deltas per (model,
region, GPU type), optionally co-optimized with cross-region routing.

Decision variables δ_{i,j,k} (integer changes to instance counts) with

  per-region coverage:   Σ_k (n+δ)·θ_{i,k} ≥ ε · max_w ρ_{i,j}(w)   ∀ i,j
  global coverage:       Σ_{j,k} (n+δ)·θ_{i,k} ≥ max_w Σ_j ρ_{i,j}(w) ∀ i
  no over-deallocation:  δ ≥ -n
  region VM capacity:    Σ_{i} gpus_k·(n+δ) ≤ cap_j                   ∀ j
  endpoint bounds:       min_inst ≤ Σ_k (n+δ) ≤ max_inst              ∀ i,j

  minimize γ + μ = Σ_k α_k Σ_{i,j} δ_{i,j,k} + Σ_{i,j,k} σ_{i,k}·max(0, δ)

max(0, δ) is linearized with auxiliary m ≥ 0, m ≥ δ.

``solve_with_routing`` extends the program with continuous spill
fractions ω_{i,j→j'} ∈ [0, 1] — the share of region j's demand for
model i served in region j' — replacing the myopic per-region coverage
by explicit traffic assignment:

  assignment:     Σ_{j'} ω_{i,j,j'} = 1                              ∀ i,j
  home minimum:   ω_{i,j,j} ≥ ε                                      ∀ i,j
  routed load:    Σ_j ρ_{i,j}·ω_{i,j,j'} ≤ Σ_k θ_{i,k}(n+δ)_{i,j',k} ∀ i,j'

  minimize γ + μ + λ · Σ_{j≠j'} ρ_{i,j}·ω_{i,j,j'}

The spill penalty λ (``spill_cost_per_tps``) is kept small relative to
the VM price α so instance deltas dominate: spilling is a tie-break
that prefers local serving, never a reason to buy capacity.  Any δ
feasible for the myopic program is feasible here (set ω to the ε-home /
transportation split), so with λ = 0 the co-optimized instance cost is
never worse, and with λ > 0 it exceeds the myopic optimum by at most
λ·(1-ε)·Σρ — negligible at the default λ.

Setting ``placed`` (and optionally ``place_cost`` / ``deployable``)
adds the third control knob — **model placement** binaries y_{i,j} with
lead-time-aware transition costs (paper §5's higher-lead-time
decisions):

  capacity gating:  Σ_k (n+δ)_{i,j,k} ≤ M_{i,j} · y_{i,j}            ∀ i,j
  routing gating:   ω_{i,j,j'} ≤ y_{i,j'}           ∀ i,j' and ρ_{i,j} > 0
  conditional min:  Σ_k (n+δ)_{i,j,k} ≥ min_inst · y_{i,j}           ∀ i,j
  conditional home: ω_{i,j,j} ≥ ε · y_{i,j}             ∀ i,j, ρ_{i,j} > 0
  not deployable:   y_{i,j} = 0 where ``deployable[i,j]`` is False

  minimize  γ + μ + λ·spill + Σ_{i,j} place_cost_{i,j} · y_{i,j}

``place_cost`` prices a *new* deployment (0 where already placed) by
its actuation lead time: warm spot retag ≪ cold local weight load ≪
remote fetch — the planner derives it from the cluster's placement
state.  Undeploying (y 1 → 0) zeroes the endpoint, so δ = -n earns
back the VM cost α·n; that asymmetry is what lets the placement-aware
plan shut down unpopular (model, region) endpoints the min-instance
floor would otherwise keep alive forever.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.sparse import coo_matrix, csr_matrix

from repro_torch.control.ilp import ILPResult, solve_ilp


@dataclasses.dataclass
class ProvisionProblem:
    n: np.ndarray            # (l, r, g) current instances
    theta: np.ndarray        # (l, g) TPS per instance of model i on GPU k
    alpha: np.ndarray        # (g,)   VM acquisition cost
    sigma: np.ndarray        # (l, g) model-deployment (cold-start) cost
    rho_peak: np.ndarray     # (l, r) max_w forecast TPS
    epsilon: float = 0.8     # min fraction served in-region
    region_cap: Optional[np.ndarray] = None   # (r,) instance capacity
    gpus_per_instance: Optional[np.ndarray] = None  # (l, g)
    min_instances: int = 2
    max_instances: Optional[int] = None
    buffer: Optional[np.ndarray] = None       # (l, r) NIW headroom β (TPS)
    # placement knob (None → placement not co-optimized, y frozen at 1)
    placed: Optional[np.ndarray] = None       # (l, r) current placement 0/1
    place_cost: Optional[np.ndarray] = None   # (l, r) $ of a new deploy
    deployable: Optional[np.ndarray] = None   # (l, r) False forces y = 0
    pinned: Optional[np.ndarray] = None       # (l, r) True forces y = 1
    #                                           (unless not deployable)


@dataclasses.dataclass
class ProvisionSolution:
    delta: np.ndarray        # (l, r, g)
    objective: float
    status: str
    nodes: int
    omega: Optional[np.ndarray] = None   # (l, r, r) routing fractions
    y: Optional[np.ndarray] = None       # (l, r) placement binaries


def _demand(problem: ProvisionProblem) -> np.ndarray:
    rho = np.asarray(problem.rho_peak, float)
    if problem.buffer is not None:
        rho = rho + np.asarray(problem.buffer, float)
    if not np.isfinite(rho).all():
        # a poisoned demand vector must fail loudly here: HiGHS
        # segfaults (not raises) on non-finite problem data
        raise ValueError("ProvisionProblem: non-finite demand "
                         "(rho_peak/buffer)")
    return rho


def _delta_bounds(problem, n, rho, theta, l, r, g):
    # Finite upper bounds keep the MIP search space compact: no model ever
    # needs more than ceil(global demand / slowest θ) extra instances.
    ub = np.empty((l, r, g))
    for i in range(l):
        need = max(rho[i].sum(), rho[i].max()) / max(theta[i].min(), 1e-9)
        ub[i] = np.ceil(need) + problem.min_instances
    ubf = ub.reshape(-1)
    nf = n.reshape(-1)
    nv = l * r * g
    bounds = [(-nf[v], ubf[v]) for v in range(nv)]
    bounds += [(0, ubf[v]) for v in range(nv)]   # m vars
    return bounds


# Cached constraint *structure* per static config: the hourly loop
# re-solves the same program shape with fresh coefficients, so the
# sparsity pattern (COO→CSR ordering), integrality mask and bounds
# skeleton are hoisted out and each solve only fills ``c``/values/rhs
# into the cached pattern.  The key captures everything the pattern
# depends on — dimensions, which optional blocks exist, and (with
# placement) the ρ>0 mask that decides which routing-gating rows are
# emitted.  Bounded; see ``_structure_for``.
_PATTERN_CACHE: Dict[Tuple, Dict[str, dict]] = {}
_PATTERN_CACHE_MAX = 256


def _structure_for(key: Tuple) -> Dict[str, dict]:
    ent = _PATTERN_CACHE.get(key)
    if ent is None:
        if len(_PATTERN_CACHE) >= _PATTERN_CACHE_MAX:
            _PATTERN_CACHE.clear()
        ent = _PATTERN_CACHE[key] = {}
    return ent


def _static_key(problem: "ProvisionProblem", routing: bool,
                rho: np.ndarray) -> Tuple:
    l, r, g = np.asarray(problem.n).shape
    key = (routing, l, r, g,
           problem.placed is not None,
           problem.region_cap is not None,
           problem.max_instances is not None,
           problem.gpus_per_instance is not None)
    if routing and problem.placed is not None:
        # routing-gating rows exist only for homes with demand
        key += ((rho > 0.0).tobytes(),)
    return key


class _RowBuilder:
    def __init__(self):
        self.rows, self.cols, self.vals, self.rhs = [], [], [], []
        self.nrow = 0

    def add(self, col_idx, col_val, rhs):
        self.rows.extend([self.nrow] * len(col_idx))
        self.cols.extend(col_idx)
        self.vals.extend(col_val)
        self.rhs.append(float(rhs))
        self.nrow += 1

    def matrix(self, ncols, structure: Optional[dict] = None):
        """CSR matrix of the emitted rows.  With a ``structure`` dict
        the COO→CSR ordering is computed once and cached in it; later
        calls with the same pattern fill coefficients straight into the
        cached ``indices``/``indptr`` (no sort, no duplicate scan)."""
        vals = np.asarray(self.vals, float)
        if structure is None:
            return coo_matrix((vals, (self.rows, self.cols)),
                              shape=(self.nrow, ncols)).tocsr()
        pat = structure.get("pat")
        if pat is None:
            coo = coo_matrix((np.arange(len(vals), dtype=float),
                              (self.rows, self.cols)),
                             shape=(self.nrow, ncols))
            csr = coo.tocsr()
            if len(csr.data) != len(vals):
                # duplicate (row, col) entries would be summed by
                # tocsr(): the permutation trick is invalid, fall back
                structure["pat"] = False
                return coo_matrix((vals, (self.rows, self.cols)),
                                  shape=(self.nrow, ncols)).tocsr()
            pat = structure["pat"] = {
                "perm": csr.data.astype(np.int64),
                "indices": csr.indices.copy(),
                "indptr": csr.indptr.copy(),
                "shape": (self.nrow, ncols)}
        elif pat is False:
            return coo_matrix((vals, (self.rows, self.cols)),
                              shape=(self.nrow, ncols)).tocsr()
        if pat["shape"] != (self.nrow, ncols) or \
                len(pat["perm"]) != len(vals):
            raise ValueError(
                "provision structure cache: emitted rows do not match "
                "the cached sparsity pattern (static key too coarse)")
        return csr_matrix((vals[pat["perm"]], pat["indices"],
                           pat["indptr"]), shape=pat["shape"])


def solve(problem: ProvisionProblem, max_nodes: int = 2000,
          backend: str = "milp",
          x0: Optional[np.ndarray] = None) -> ProvisionSolution:
    n = np.asarray(problem.n, float)
    l, r, g = n.shape
    theta = np.asarray(problem.theta, float)
    rho = _demand(problem)
    struct = _structure_for(_static_key(problem, False, rho))
    nv = l * r * g

    def vid(i, j, k):  # delta var id
        return (i * r + j) * g + k

    c = np.zeros(2 * nv)
    c[:nv] = np.broadcast_to(problem.alpha, (l, r, g)).reshape(-1)
    c[nv:] = np.broadcast_to(np.asarray(problem.sigma)[:, None, :],
                             (l, r, g)).reshape(-1)

    ub = _RowBuilder()

    # m >= delta  ->  delta - m <= 0
    for v in range(nv):
        ub.add([v, nv + v], [1.0, -1.0], 0.0)

    # per-region coverage: -Σ_k θ_{ik} δ_{ijk} <= Σ_k θ n - ε ρ
    for i in range(l):
        for j in range(r):
            ub.add([vid(i, j, k) for k in range(g)],
                   [-theta[i, k] for k in range(g)],
                   (theta[i] * n[i, j]).sum() - problem.epsilon * rho[i, j])

    # global coverage per model
    for i in range(l):
        idx = [vid(i, j, k) for j in range(r) for k in range(g)]
        val = [-theta[i, k] for j in range(r) for k in range(g)]
        rhs = (theta[i][None, :] * n[i]).sum() - rho[i].sum()
        ub.add(idx, val, rhs)

    _add_shared_rows(ub, problem, n, l, r, g, vid)

    A_ub = ub.matrix(2 * nv, structure=struct)
    bounds = _delta_bounds(problem, n, rho, theta, l, r, g)
    integrality = struct.get("integrality")
    if integrality is None:
        integrality = struct["integrality"] = np.concatenate(
            [np.ones(nv, bool), np.zeros(nv, bool)])
    res = solve_ilp(np.asarray(c), A_ub=A_ub,
                    b_ub=np.asarray(ub.rhs), bounds=bounds,
                    integrality=integrality, max_nodes=max_nodes,
                    backend=backend, x0=x0)
    delta = res.x[:nv].reshape(l, r, g)
    return ProvisionSolution(delta=delta, objective=res.objective,
                             status=res.status, nodes=res.nodes)


def _add_shared_rows(ub: _RowBuilder, problem, n, l, r, g, vid, yid=None):
    """Rows common to both programs: region capacity and endpoint
    min/max instance counts.  With placement binaries (``yid``) the
    min-instance floor is conditional — min_inst · y ≤ Σ (n+δ) — so an
    undeployed endpoint may legally drop to zero."""
    if problem.region_cap is not None:
        gpi = (problem.gpus_per_instance
               if problem.gpus_per_instance is not None
               else np.ones((l, g)))
        for j in range(r):
            idx = [vid(i, j, k) for i in range(l) for k in range(g)]
            val = [gpi[i, k] for i in range(l) for k in range(g)]
            rhs = problem.region_cap[j] - sum(
                gpi[i, k] * n[i, j, k] for i in range(l) for k in range(g))
            ub.add(idx, val, rhs)

    for i in range(l):
        for j in range(r):
            idx = [vid(i, j, k) for k in range(g)]
            if yid is None:
                ub.add(idx, [-1.0] * g,
                       n[i, j].sum() - problem.min_instances)
            else:
                ub.add(idx + [yid(i, j)],
                       [-1.0] * g + [float(problem.min_instances)],
                       n[i, j].sum())
            if problem.max_instances is not None:
                ub.add(idx, [1.0] * g,
                       problem.max_instances - n[i, j].sum())


def solve_with_routing(problem: ProvisionProblem,
                       spill_cost_per_tps: float = 1e-3,
                       max_nodes: int = 2000, backend: str = "milp",
                       x0: Optional[np.ndarray] = None
                       ) -> ProvisionSolution:
    """Co-optimize instance deltas with cross-region routing fractions
    ω_{i,j→j'} — and, when ``problem.placed`` is set, with placement
    binaries y_{i,j} priced by lead-time-aware transition costs (see
    module docstring).  Returns a solution whose ``omega[i, j]`` rows
    are the traffic split of (model i, home j) and whose ``y`` is the
    target placement."""
    n = np.asarray(problem.n, float)
    l, r, g = n.shape
    theta = np.asarray(problem.theta, float)
    rho = _demand(problem)
    placement = problem.placed is not None
    struct = _structure_for(_static_key(problem, True, rho))
    nv = l * r * g
    nw = l * r * r
    ny = l * r if placement else 0
    ntot = 2 * nv + nw + ny

    def vid(i, j, k):  # delta var id
        return (i * r + j) * g + k

    def wid(i, j, jp):  # spill var id (offset by 2*nv)
        return 2 * nv + (i * r + j) * r + jp

    def yid(i, j):  # placement var id (offset by 2*nv + nw)
        return 2 * nv + nw + i * r + j

    c = np.zeros(ntot)
    c[:nv] = np.broadcast_to(problem.alpha, (l, r, g)).reshape(-1)
    c[nv:2 * nv] = np.broadcast_to(np.asarray(problem.sigma)[:, None, :],
                                   (l, r, g)).reshape(-1)
    for i in range(l):
        for j in range(r):
            for jp in range(r):
                if jp != j:
                    c[wid(i, j, jp)] = spill_cost_per_tps * rho[i, j]

    placed = (np.asarray(problem.placed, float).reshape(l, r)
              if placement else None)
    deployable = (np.ones((l, r), bool) if problem.deployable is None
                  else np.asarray(problem.deployable, bool).reshape(l, r))
    if placement and problem.place_cost is not None:
        pc = np.asarray(problem.place_cost, float).reshape(l, r)
        for i in range(l):
            for j in range(r):
                # transitions are only priced on *new* deploys
                if placed[i, j] < 0.5 and np.isfinite(pc[i, j]):
                    c[yid(i, j)] = pc[i, j]

    ub = _RowBuilder()

    # m >= delta  ->  delta - m <= 0
    for v in range(nv):
        ub.add([v, nv + v], [1.0, -1.0], 0.0)

    # home minimum: -ω_{ijj} <= -ε  (harmless for zero-demand keys: the
    # routed-load coefficient ρ·ω is 0 there, so it cannot bind
    # capacity).  With placement the floor is conditional — an
    # undeployed home must be able to spill everything away.
    for i in range(l):
        for j in range(r):
            if placement:
                ub.add([wid(i, j, j), yid(i, j)],
                       [-1.0, problem.epsilon], 0.0)
            else:
                ub.add([wid(i, j, j)], [-1.0], -problem.epsilon)

    # routed load fits capacity:
    #   Σ_j ρ_{ij} ω_{ijj'} - Σ_k θ_{ik} δ_{ij'k} <= Σ_k θ_{ik} n_{ij'k}
    for i in range(l):
        for jp in range(r):
            idx = [wid(i, j, jp) for j in range(r)]
            val = [rho[i, j] for j in range(r)]
            idx += [vid(i, jp, k) for k in range(g)]
            val += [-theta[i, k] for k in range(g)]
            ub.add(idx, val, (theta[i] * n[i, jp]).sum())

    # global coverage per model (redundant given the routed-load rows +
    # assignment equalities, but keeps the LP relaxation tight)
    for i in range(l):
        idx = [vid(i, j, k) for j in range(r) for k in range(g)]
        val = [-theta[i, k] for j in range(r) for k in range(g)]
        rhs = (theta[i][None, :] * n[i]).sum() - rho[i].sum()
        ub.add(idx, val, rhs)

    _add_shared_rows(ub, problem, n, l, r, g, vid,
                     yid=yid if placement else None)

    if placement:
        # big-M capacity gating: Σ_k (n+δ) <= M·y, so y = 0 forces the
        # endpoint to zero instances (δ = -n) and y = 1 is implied by
        # any positive capacity
        ubf = _delta_bounds(problem, n, rho, theta, l, r, g)
        for i in range(l):
            for j in range(r):
                big_m = n[i, j].sum() + sum(
                    ubf[vid(i, j, k)][1] for k in range(g))
                if problem.max_instances is not None:
                    big_m = min(big_m, float(problem.max_instances))
                ub.add([vid(i, j, k) for k in range(g)] + [yid(i, j)],
                       [1.0] * g + [-float(big_m)], -n[i, j].sum())
        # routing gating for loaded homes: ω_{ijj'} <= y_{ij'} — no
        # traffic may be planned into an undeployed region.  Zero-demand
        # homes are skipped: their ω carries no load, and gating them
        # would make the assignment equality infeasible for a model
        # undeployed everywhere.
        for i in range(l):
            for j in range(r):
                if rho[i, j] <= 0.0:
                    continue
                for jp in range(r):
                    ub.add([wid(i, j, jp), yid(i, jp)], [1.0, -1.0], 0.0)

    # assignment: Σ_{j'} ω_{ijj'} = 1
    eq = _RowBuilder()
    for i in range(l):
        for j in range(r):
            eq.add([wid(i, j, jp) for jp in range(r)], [1.0] * r, 1.0)

    bounds = _delta_bounds(problem, n, rho, theta, l, r, g)
    bounds += [(0.0, 1.0)] * nw
    if placement:
        pinned = (np.zeros((l, r), bool) if problem.pinned is None
                  else np.asarray(problem.pinned, bool).reshape(l, r))
        # an outage (not deployable) outranks a demand pin
        bounds += [((0.0, 0.0) if not deployable[i, j] else
                    (1.0, 1.0) if pinned[i, j] else (0.0, 1.0))
                   for i in range(l) for j in range(r)]
    integrality = struct.get("integrality")
    if integrality is None:
        integrality = struct["integrality"] = np.concatenate(
            [np.ones(nv, bool), np.zeros(nv + nw, bool),
             np.ones(ny, bool)])
    eq_struct = struct.setdefault("eq", {})
    res = solve_ilp(np.asarray(c), A_ub=ub.matrix(ntot, structure=struct),
                    b_ub=np.asarray(ub.rhs),
                    A_eq=eq.matrix(ntot, structure=eq_struct),
                    b_eq=np.asarray(eq.rhs), bounds=bounds,
                    integrality=integrality, max_nodes=max_nodes,
                    backend=backend, x0=x0)
    delta = res.x[:nv].reshape(l, r, g)
    omega = res.x[2 * nv:2 * nv + nw].reshape(l, r, r)
    y = (np.round(res.x[2 * nv + nw:]).reshape(l, r)
         if placement else None)
    return ProvisionSolution(delta=delta, objective=res.objective,
                             status=res.status, nodes=res.nodes,
                             omega=omega, y=y)
