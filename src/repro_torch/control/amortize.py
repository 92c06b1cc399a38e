"""Cross-replica / cross-hour ILP amortization (PERF: control plane).

A sweep runs the *same* controller configuration over many replicas
(seeds × strategies share scenario inputs), so the hourly
:class:`~repro_torch.control.provision.ProvisionProblem` instances repeat:
identical histories produce identical demand vectors, and the solver is
deterministic, so identical problems have identical solutions.  This
module provides the dedupe layer:

* :func:`problem_fingerprint` — a stable digest of everything the solve
  reads (demand, deployability, lead prices, bounds inputs, program
  flavor), quantized at ``decimals=9`` to match the solver's own output
  rounding (``np.round(x, 9)`` in :mod:`repro_torch.control.ilp`).
* :class:`SolveCache` — a bounded, lock-protected fingerprint →
  :class:`~repro_torch.control.provision.ProvisionSolution` map.  Thread-safe
  so boundary solves may run on a pool; hits return deep copies so
  callers can't corrupt cached entries.
* :func:`solve_amortized` — fingerprint, look up, else solve (and, for
  ``backend="bnb"``, warm-start from the previous solution of the same
  static program shape).  Because the cache key covers every input of
  the solve and the backends are deterministic, a hit is *bit-identical*
  to re-solving — the parity tests assert exactly that.

Warm starts never change the reported objective (the bnb backend only
seeds the incumbent; the default ``milp`` backend ignores ``x0``
entirely), so plans stay bit-identical to the cold path.
"""
from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.control.provision import (ProvisionProblem, ProvisionSolution,
                                     _demand, _static_key, solve,
                                     solve_with_routing)


def _part(a, decimals: int) -> bytes:
    if a is None:
        return b"-"
    arr = np.ascontiguousarray(np.round(np.asarray(a, float), decimals))
    return repr(arr.shape).encode() + arr.tobytes()


# reprolint: cache-key=ProvisionProblem
def problem_fingerprint(problem: ProvisionProblem, use_routing: bool,
                        spill_cost_per_tps: float = 0.0,
                        decimals: int = 9) -> bytes:
    """Digest of every input the solve reads.  Two problems with equal
    fingerprints yield bit-identical solutions (deterministic solver).
    R7 (cache-key completeness) gates that every ``ProvisionProblem``
    field stays hashed here — a new field fails lint until it is."""
    h = hashlib.blake2b(digest_size=16)
    for a in (problem.n, problem.theta, problem.alpha, problem.sigma,
              problem.rho_peak, problem.buffer, problem.region_cap,
              problem.gpus_per_instance, problem.placed,
              problem.place_cost, problem.deployable, problem.pinned):
        h.update(_part(a, decimals))
        h.update(b"|")
    h.update(repr((float(problem.epsilon), int(problem.min_instances),
                   None if problem.max_instances is None
                   else int(problem.max_instances),
                   bool(use_routing),
                   round(float(spill_cost_per_tps), 12))).encode())
    return h.digest()


def _copy_solution(sol: ProvisionSolution) -> ProvisionSolution:
    return ProvisionSolution(
        delta=np.array(sol.delta, copy=True), objective=sol.objective,
        status=sol.status, nodes=sol.nodes,
        omega=None if sol.omega is None else np.array(sol.omega, copy=True),
        y=None if sol.y is None else np.array(sol.y, copy=True))


class SolveCache:
    """Bounded LRU of fingerprint → solution, plus per-static-shape
    warm-start points for the bnb backend.  All methods thread-safe."""

    def __init__(self, max_entries: int = 8192):
        self._max = max_entries
        self._lock = threading.Lock()
        self._sols: "collections.OrderedDict[bytes, ProvisionSolution]" = \
            collections.OrderedDict()
        self._warm: Dict[Tuple, np.ndarray] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, sig: bytes) -> Optional[ProvisionSolution]:
        with self._lock:
            sol = self._sols.get(sig)
            if sol is None:
                self.misses += 1
                return None
            self._sols.move_to_end(sig)
            self.hits += 1
            return _copy_solution(sol)

    def put(self, sig: bytes, sol: ProvisionSolution) -> None:
        with self._lock:
            self._sols[sig] = _copy_solution(sol)
            self._sols.move_to_end(sig)
            while len(self._sols) > self._max:
                self._sols.popitem(last=False)
                self.evictions += 1

    def warm_get(self, key: Tuple) -> Optional[np.ndarray]:
        with self._lock:
            x = self._warm.get(key)
            return None if x is None else x.copy()

    def warm_put(self, key: Tuple, x: np.ndarray) -> None:
        with self._lock:
            if len(self._warm) > 1024:
                self._warm.clear()
            self._warm[key] = np.asarray(x, float).copy()

    def clear(self) -> None:
        with self._lock:
            self._sols.clear()
            self._warm.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    def cache_stats(self) -> Dict[str, int]:
        """Uniform cache telemetry (see docs/PERF.md): lifetime hit/
        miss/eviction counts plus current size."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "entries": len(self._sols)}

    def stats(self) -> Dict[str, int]:
        return self.cache_stats()


#: process-wide default used by the planner; cleared by the parity tests
DEFAULT_CACHE = SolveCache()


def clear_solve_cache() -> None:
    DEFAULT_CACHE.clear()


def _warm_x(problem: ProvisionProblem, sol: ProvisionSolution,
            use_routing: bool) -> Optional[np.ndarray]:
    """Reconstruct the full decision vector [δ, m, (ω, y)] from a
    solution — the warm-start seed for the next hour's bnb solve.  At
    any optimum m = max(0, δ) (σ ≥ 0), so the point is feasible for the
    linearization rows."""
    delta = np.asarray(sol.delta, float).reshape(-1)
    parts = [delta, np.maximum(0.0, delta)]
    if use_routing:
        if sol.omega is None:
            return None
        parts.append(np.asarray(sol.omega, float).reshape(-1))
        if problem.placed is not None:
            if sol.y is None:
                return None
            parts.append(np.asarray(sol.y, float).reshape(-1))
    return np.concatenate(parts)


def solve_amortized(problem: ProvisionProblem,
                    use_routing: bool = False,
                    spill_cost_per_tps: float = 1e-3,
                    max_nodes: int = 2000, backend: str = "milp",
                    cache: Optional[SolveCache] = None
                    ) -> ProvisionSolution:
    """Fingerprint-deduped solve: identical problems across replicas or
    hours are solved once.  Misses fall through to the real solver
    (warm-started for ``backend="bnb"``) and populate the cache."""
    if cache is None:
        cache = DEFAULT_CACHE
    sig = problem_fingerprint(problem, use_routing, spill_cost_per_tps)
    hit = cache.get(sig)
    if hit is not None:
        return hit
    wkey = None
    x0 = None
    if backend == "bnb":
        wkey = _static_key(problem, use_routing, _demand(problem))
        x0 = cache.warm_get(wkey)
    if use_routing:
        sol = solve_with_routing(problem,
                                 spill_cost_per_tps=spill_cost_per_tps,
                                 max_nodes=max_nodes, backend=backend,
                                 x0=x0)
    else:
        sol = solve(problem, max_nodes=max_nodes, backend=backend, x0=x0)
    cache.put(sig, sol)
    if wkey is not None and sol.status != "infeasible":
        xw = _warm_x(problem, sol, use_routing)
        if xw is not None:
            cache.warm_put(wkey, xw)
    return sol
