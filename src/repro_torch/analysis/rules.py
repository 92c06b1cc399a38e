"""Rule registry: every reprolint rule module of the port, in report order.

A rule module exposes ``RULE_ID: str`` and
``check(model: ProjectModel) -> List[Violation]``.  The reference's
rules but R6 (JAX/Pallas hazards; the port imports no jax), plus R8,
its torch counterpart.  To add a rule, drop a ``rules_<name>.py``
module next to this file and append it here (see docs/ANALYSIS.md).
"""
from __future__ import annotations

from repro_torch.analysis import (rules_cachekey, rules_capability,
                                  rules_determinism, rules_readmutation,
                                  rules_registry, rules_roundtrip,
                                  rules_torch)

ALL_RULES = (
    rules_registry,       # R1 registry/protocol conformance
    rules_roundtrip,      # R2 spec round-trip completeness
    rules_capability,     # R3 capability-probe integrity
    rules_determinism,    # R4 determinism hazards
    rules_readmutation,   # R5 defaultdict read-path mutation
    rules_cachekey,       # R7 cache-key completeness
    rules_torch,          # R8 torch/CUDA hazards
)

RULE_DOCS = {mod.RULE_ID: (mod.__doc__ or "").strip().splitlines()[0]
             for mod in ALL_RULES}
