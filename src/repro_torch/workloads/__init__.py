"""repro_torch.workloads: production-grade workload library.

Named, calibrated :class:`WorkloadFamily` specs (multi-turn chat
sessions, heavy-tailed long-context, NIW floods, flash crowds,
preemption storms, region-shifted mixes) that compile to the columnar
``Trace``.  The scenario fuzzer (``repro.workloads.fuzz``) drives the
vector engine and waits for its port.

See docs/WORKLOADS.md for the family catalog.
"""
from repro_torch.workloads.families import (FAMILIES, FlashCrowd,
                                            FloodWindow, PreemptionStorm,
                                            SessionProfile, WorkloadFamily,
                                            family_workload)
from repro_torch.workloads.generate import compile_family

__all__ = [
    "FAMILIES", "FlashCrowd", "FloodWindow", "PreemptionStorm",
    "SessionProfile", "WorkloadFamily", "family_workload",
    "compile_family",
]
