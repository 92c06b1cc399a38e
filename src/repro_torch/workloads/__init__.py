"""repro_torch.workloads: workload library and scenario fuzzer.

Named, calibrated :class:`WorkloadFamily` specs (multi-turn chat
sessions, heavy-tailed long-context, NIW floods, flash crowds,
preemption storms, region-shifted mixes) that compile to the columnar
``Trace``, and a deterministic scenario fuzzer that composes stress
axes into vector-engine experiment grids scored as dollar/SLA
frontiers (``benchmarks/fuzz_report.py`` → ``BENCH_fuzz.json``).

See docs/WORKLOADS.md for the family catalog and the fuzzer grammar.
"""
from repro_torch.workloads.families import (FAMILIES, FlashCrowd,
                                            FloodWindow, PreemptionStorm,
                                            SessionProfile, WorkloadFamily,
                                            family_workload)
from repro_torch.workloads.fuzz import (BASELINE_STACK, STACK_NAMES,
                                        FuzzScenario, FuzzSpec,
                                        fuzz_experiment, fuzz_scenarios,
                                        fuzz_stack, score_results)
from repro_torch.workloads.generate import compile_family

__all__ = [
    "FAMILIES", "FlashCrowd", "FloodWindow", "PreemptionStorm",
    "SessionProfile", "WorkloadFamily", "family_workload",
    "compile_family",
    "BASELINE_STACK", "STACK_NAMES", "FuzzScenario", "FuzzSpec",
    "fuzz_experiment", "fuzz_scenarios", "fuzz_stack", "score_results",
]
