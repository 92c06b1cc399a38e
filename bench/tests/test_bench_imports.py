"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

GUARD = r"""
import sys, time
sys.modules["jax"] = None
sys.path.insert(0, {bench!r})
import run
run.setup_environment()
from pathlib import Path
from bench.harness import runner, spec
from bench.tests.tiny import make_root
import tempfile, itertools, torch
torch.set_num_threads(1)
root = make_root(Path(tempfile.mkdtemp()))
c = itertools.count()
out = runner.execute(root, spec.load_cell(root, "tiny-hybrid.short"), 1, 0.5,
                     False, "cpu", time.perf_counter(),
                     clock=lambda: next(c) * 1e-3)
for m in ("k1_roofline", "mfu", "iw_ttft_p95_ms.admission"):
    spec.reader(Path({root!r}), m)
tops = sorted({{n.split(".")[0] for n, m in sys.modules.items()
               if m is not None}})
print(" ".join(tops))
print(run.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = GUARD.format(bench=str(BENCH), root=str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=BENCH.parent,
                         env={"PYTHONPATH": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    tops, forbidden = out.stdout.strip().splitlines()[-2:]
    names = set(tops.split())
    assert "repro_torch" in names and "bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    assert forbidden == "[]"


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    saved = sys.modules.get("repro")
    sys.modules["repro"] = object()
    try:
        assert "repro" in run.forbidden_modules()
    finally:
        if saved is None:
            del sys.modules["repro"]
        else:
            sys.modules["repro"] = saved
    assert "repro_torch" not in run.FORBIDDEN


def test_references_import_nothing_of_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top in {"torch", "math", "contextlib", "typing",
                               "__future__", "bench"}, (path.name, n)
                assert not n.startswith("bench.harness"), (path.name, n)
