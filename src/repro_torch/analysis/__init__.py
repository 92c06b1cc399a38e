"""reprolint for the port — static analysis for the duck-typed control plane.

Counterpart of ``repro.analysis``, with its two tiers (see
docs/ANALYSIS.md):

- the AST tier (R0-R5, R7, and R8, the torch counterpart of the
  reference's R6): analyzed code is parsed, never imported;
- the trace tier (T1-T4, ``--trace``): runs the port's two hot programs,
  the vector engine's segment and the batched forecast fit, on the
  device and checks what they dispatch — import it lazily via
  ``repro_torch.analysis.trace`` (it pulls in the engine).

Usage::

    python -m repro_torch.analysis [--json] [--trace [--device cpu]] [paths...]

or programmatically::

    from repro_torch.analysis import run_lint
    result = run_lint(["src/repro_torch"])
    assert not result.violations
"""
from repro_torch.analysis.core import (LintResult, Violation, run_lint)
from repro_torch.analysis.rules import ALL_RULES, RULE_DOCS

__all__ = ["ALL_RULES", "LintResult", "RULE_DOCS", "Violation", "run_lint"]
