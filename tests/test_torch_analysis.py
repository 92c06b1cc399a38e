"""reprolint's AST tier in the port (``src/repro_torch/analysis``) against the reference's.

The port's copy runs every shared rule (R0-R5, R7, W0) over the
reference's fixtures in ``tests/lint_fixtures/`` and must report the
same ``(rule, file, line)`` findings as ``repro.analysis``; only R6
(JAX/Pallas hazards, not run by the port) may differ.  R8, the port's
torch counterpart of R6, fires on ``tests/torch_lint_fixtures/``, whose
files carry a sentinel comment (``# R8-VIOLATION-...``) on each line
expected to fire.  Both packages' own sources stay clean.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import run_lint as ref_run_lint
from repro_torch.analysis import ALL_RULES, run_lint

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
FIXTURES = REPO / "tests" / "lint_fixtures"
TORCH_FIXTURES = REPO / "tests" / "torch_lint_fixtures"
SHARED = ("R0", "R1", "R2", "R3", "R4", "R5", "R7", "W0")


@pytest.fixture(scope="module")
def both_on_fixtures():
    return run_lint([str(FIXTURES)]), ref_run_lint([str(FIXTURES)])


@pytest.fixture(scope="module")
def torch_fixture_result():
    return run_lint([str(TORCH_FIXTURES)])


def _found(result, rule):
    every = result.violations + result.suppressed + result.warnings
    return {(v.rule, v.file, v.line) for v in every if v.rule == rule}


def _marker_lines(fname, marker):
    return [i for i, line in enumerate(
        (TORCH_FIXTURES / fname).read_text().splitlines(), 1)
        if marker in line]


def _r8(result, fname):
    return {v.line for v in result.violations
            if v.rule == "R8" and v.file.endswith(fname)}


# ------------------------------------------------------ parity with repro
@pytest.mark.parametrize("rule", SHARED)
def test_shared_rule_findings_match_the_reference(both_on_fixtures, rule):
    port, ref = both_on_fixtures
    assert _found(port, rule) == _found(ref, rule)
    if rule != "W0":
        assert _found(ref, rule), f"the fixtures exercise {rule}"


def test_port_runs_r8_in_place_of_r6(both_on_fixtures):
    port, ref = both_on_fixtures
    assert [m.RULE_ID for m in ALL_RULES] == ["R1", "R2", "R3", "R4", "R5",
                                              "R7", "R8"]
    assert _found(ref, "R6") and not _found(port, "R6")
    # the reference's fixtures import no torch: R8 has nothing to say
    assert not _found(port, "R8")
    assert port.files_checked == ref.files_checked


# ----------------------------------------------------------- R8 fires
@pytest.mark.parametrize("marker", [
    "R8-VIOLATION-ITEM", "R8-VIOLATION-CPU", "R8-VIOLATION-SYNC",
    "R8-VIOLATION-ALIASED-SYNC", "R8-VIOLATION-INT", "R8-VIOLATION-FLOAT",
    "R8-VIOLATION-COMPILE", "R8-VIOLATION-SCRIPT", "R8-VIOLATION-GRAPH",
    "R8-VIOLATION-LOAD", "R8-VIOLATION-CDLL"])
def test_r8_fires_on_each_hazard(torch_fixture_result, marker):
    lines = _marker_lines("bad_r8.py", marker)
    assert len(lines) == 1
    assert lines[0] in _r8(torch_fixture_result, "bad_r8.py")


def test_r8_fires_only_on_marked_lines(torch_fixture_result):
    marked = set(_marker_lines("bad_r8.py", "R8-VIOLATION"))
    assert _r8(torch_fixture_result, "bad_r8.py") == marked
    assert len(marked) == 11


def test_r8_silent_on_allowlisted_paths_and_torch_free_modules(
        torch_fixture_result):
    assert not _r8(torch_fixture_result, "launch/measure.py")
    assert not _r8(torch_fixture_result, "no_torch.py")


def test_r8_exempts_the_library_cache_owner_only(torch_fixture_result):
    assert _r8(torch_fixture_result, "kernels/_build.py") == set(
        _marker_lines("kernels/_build.py", "R8-VIOLATION-UNCACHED"))


def test_r8_reasoned_suppression_suppresses_and_is_not_stale(
        torch_fixture_result):
    line = _marker_lines("bad_r8.py", "R8-SUPPRESSED")[0]
    assert line not in _r8(torch_fixture_result, "bad_r8.py")
    assert any(v.rule == "R8" and v.line == line
               for v in torch_fixture_result.suppressed)
    assert not torch_fixture_result.warnings


def test_r8_stale_suppression_warns(tmp_path):
    f = tmp_path / "stale.py"
    f.write_text("import torch\n\n\ndef f(x):\n"
                 "    # reprolint: disable=R8 -- nothing fires here\n"
                 "    return x + 1\n")
    result = run_lint([str(f)])
    assert [(w.rule, w.line) for w in result.warnings] == [("W0", 5)]
    assert not result.violations


# ------------------------------------------------------- clean corpora
def test_port_source_is_clean_with_no_stale_suppressions():
    result = run_lint([str(SRC / "repro_torch")])
    msgs = "\n".join(v.render() for v in result.violations + result.warnings)
    assert not result.violations and not result.warnings, msgs
    # the two R8 findings of the port's own code carry their reasons
    assert {v.rule for v in result.suppressed} >= {"R8"}


def test_reference_source_stays_clean_with_no_stale_suppressions():
    result = ref_run_lint([str(SRC)])
    msgs = "\n".join(v.render() for v in result.violations + result.warnings)
    assert not result.violations and not result.warnings, msgs


def test_port_suppresses_nothing_as_r6():
    offenders = [str(p.relative_to(REPO))
                 for p in sorted((SRC / "repro_torch").rglob("*.py"))
                 if "disable=R6" in p.read_text()]
    assert not offenders


def test_default_paths_lint_the_port():
    result = run_lint()
    assert result.files_checked == len(list(
        (SRC / "repro_torch").rglob("*.py")))
    assert not result.violations


# ------------------------------------------------------------------ CLI
def _cli(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=120)


def test_json_cli_matches_the_reference_but_r6():
    port = _cli("repro_torch.analysis", "--json", str(FIXTURES))
    ref = _cli("repro.analysis", "--json", str(FIXTURES))
    assert port.returncode == ref.returncode == 1
    got, want = json.loads(port.stdout), json.loads(ref.stdout)
    want["counts"].pop("R6")
    assert got["counts"] == want["counts"]
    assert got["files_checked"] == want["files_checked"]
    assert len(got["warnings"]) == len(want["warnings"]) >= 1


def test_clean_port_cli_exits_zero():
    for args in ((str(SRC / "repro_torch"),), ()):
        proc = _cli("repro_torch.analysis", *args)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 violation(s)" in proc.stdout


def test_cli_rules_filter_and_catalog():
    proc = _cli("repro_torch.analysis", "--json", "--rules", "R8",
                str(TORCH_FIXTURES))
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["counts"] == {"R8": 12}
    proc = _cli("repro_torch.analysis", "--list-rules")
    assert proc.returncode == 0
    ids = [line.split(":")[0] for line in proc.stdout.splitlines()]
    assert ids == ["R1", "R2", "R3", "R4", "R5", "R7", "R8",
                   "T1", "T2", "T3", "T4"]


def test_cli_warnings_never_gate_the_exit_code(tmp_path):
    f = tmp_path / "stale.py"
    f.write_text("x = 1  # reprolint: disable=R4 -- nothing fires here\n")
    proc = _cli("repro_torch.analysis", str(f))
    assert proc.returncode == 0
    assert "1 warning(s)" in proc.stdout
