"""The four ``examples/torch_*.py`` run on the CPU with JAX and ``repro`` unimportable.

Each example runs at a small size with ``--device cpu`` in a subprocess
whose ``sys.modules["jax"]`` and ``sys.modules["repro"]`` are ``None``
(the card's host has no JAX), and must exit 0.  The strategy shoot-out
writes out the reference's seven stacks (``benchmarks.common`` imports
jax); they are held here to ``benchmarks.common.stack_spec`` at
``BenchSpec()``'s defaults.
"""
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"

RUNNER = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['repro'] = None\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
    "             and sys.modules[m] is not None)\n"
    "assert not bad, bad\n")


def _run(name, *args, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "-c", RUNNER, str(EXAMPLES / name), "--device",
         "cpu", *args], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=240)


@pytest.mark.parametrize("name,args,expect", [
    ("torch_quickstart.py", ("--days", "0.03", "--scale", "0.02"),
     "SageServe LT-UA vs Reactive"),
    ("torch_autoscale_simulation.py",
     ("--days", "0.03", "--scale", "0.02", "--jobs", "1"),
     "chiron"),
    ("torch_serve_cluster.py", (), "served 15 requests (9 IW / 6 NIW)"),
    ("torch_train_small.py",
     ("--steps", "10", "--layers", "2", "--d-model", "64"), "loss "),
])
def test_example_runs_on_the_cpu_without_jax(name, args, expect, tmp_path):
    if name == "torch_train_small.py":
        args = args + ("--ckpt", str(tmp_path / "ckpt.npz"))
    proc = _run(name, *args, tmp_path=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert expect in proc.stdout
    if name == "torch_train_small.py":
        assert (tmp_path / "ckpt.npz").exists()


def test_examples_default_to_cuda_and_raise_without_it(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_serve_cluster.py")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_shootout_strategies_equal_the_reference_stacks():
    from benchmarks.common import STRATEGIES, BenchSpec, stack_spec

    mod = runpy.run_path(str(EXAMPLES / "torch_autoscale_simulation.py"))
    assert mod["STRATEGIES"] == STRATEGIES
    assert mod["INITIAL_INSTANCES"] == BenchSpec().initial_instances
    ours = mod["strategies"]()
    assert tuple(ours) == STRATEGIES
    for s in STRATEGIES:
        assert ours[s].to_dict() == stack_spec(BenchSpec(), s).to_dict(), s
