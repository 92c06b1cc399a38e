"""Vectorized mega-scale simulation core (docs/PERF.md).

A batched fast path that advances many (variant, seed) replicas in
lockstep over the columnar ``Trace``: struct-of-arrays state per
(replica, cell, region) stepped in fixed time buckets by the
``bucket_step`` kernel (one block per replica, the carry in shared
memory for a whole segment) or, on the CPU, its plain version, pausing at
control-plane boundaries (hourly forecast/ILP/placement, scenario
outages) where the *same* Python planner objects the event loop drives
produce a ``Plan`` that is applied back into array state.

Use ``ExperimentSpec(engine="vector")`` or
``ServingStack.simulate_vector`` — stacks built by ``build_stack`` run
unmodified on either engine.
"""
from repro_torch.sim.vector.engine import (VectorBatch, VectorSimulation,
                                           VectorUnsupported)

__all__ = ["VectorBatch", "VectorSimulation", "VectorUnsupported"]
