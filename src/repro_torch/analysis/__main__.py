"""CLI entry point: ``python -m repro_torch.analysis [--json] [--trace] [paths]``.

Exits 0 when no unsuppressed violations are found (AST tier, plus the
trace tier when ``--trace`` is given), 1 otherwise.  W0 stale-
suppression warnings are reported but never gate the exit code.  The
trace tier runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import ALL_RULES, RULE_DOCS, run_lint

TRACE_BUDGET_S = 60.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint: AST-based contract checker "
                    "(see docs/ANALYSIS.md)")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to lint "
                             "(default: the repro_torch source tree)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit machine-readable JSON")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--trace", action="store_true",
                        help="also run the trace tier (T1-T4): run the "
                             "hot paths on the device and check what "
                             "they dispatch")
    parser.add_argument("--device", default=None,
                        help="device of the trace tier (default: cuda)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        from repro_torch.analysis.trace import TRACE_RULE_DOCS
        for mod in ALL_RULES:
            print(f"{mod.RULE_ID}: {RULE_DOCS[mod.RULE_ID]}")
        for rid, doc in TRACE_RULE_DOCS.items():
            print(f"{rid}: {doc} (--trace)")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    result = run_lint(args.paths or None, rules=rules)

    trace_result = None
    if args.trace:
        from repro_torch.analysis.trace import run_trace
        trace_result = run_trace(device=args.device)

    failed = bool(result.violations) or \
        bool(trace_result and trace_result.violations)

    if args.as_json:
        data = result.to_json()
        if trace_result is not None:
            data["trace"] = trace_result.to_json()
        print(json.dumps(data, indent=1, sort_keys=True))
        return 1 if failed else 0

    for v in result.violations:
        print(v.render())
    for w in result.warnings:
        print(f"{w.render()} [warning]")
    n = len(result.violations)
    print(f"reprolint: {result.files_checked} file(s), "
          f"{n} violation(s), {len(result.suppressed)} suppressed, "
          f"{len(result.warnings)} warning(s)")
    if trace_result is not None:
        for v in trace_result.violations:
            print(v.render())
        over = "" if trace_result.elapsed_s <= TRACE_BUDGET_S else \
            f" — OVER the {TRACE_BUDGET_S:.0f}s budget"
        print(f"trace tier ({trace_result.device}): "
              f"{len(trace_result.checks)} check(s), "
              f"{len(trace_result.violations)} violation(s) in "
              f"{trace_result.elapsed_s:.1f}s{over}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
