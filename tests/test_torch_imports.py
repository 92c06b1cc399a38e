"""repro_torch stands alone: no jax, no repro, and CUDA unless asked otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_imports_with_jax_and_repro_blocked():
    """Every module of the port imports with ``jax`` and ``repro`` made
    unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_imports_jax_or_repro():
    """An AST check over every file: the module's top-level package must
    not be ``jax`` or ``repro`` (``repro_torch`` is its own package)."""
    files = sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    offenders = []
    for path in files:
        for name in _imported_modules(ast.parse(path.read_text())):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                offenders.append(f"{path.relative_to(SRC.parent)}: {name}")
    assert not offenders, offenders
    assert len(files) >= 20


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduce_for_smoke(get_arch("starcoder2-7b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_decode_cache(cfg, 1, 8)
    lm = model.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, lm, max_batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])


def test_vector_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.api import (ExperimentSpec, StackSpec, build_stack,
                                 run_experiment)
    from repro_torch.core.scaling import make_policy
    from repro_torch.sim.simulator import SimConfig
    from repro_torch.sim.vector import VectorBatch, VectorSimulation
    from repro_torch.sim.workload import (PAPER_MODELS, REGIONS,
                                          WorkloadSpec, generate_trace)

    trace = generate_trace(WorkloadSpec(days=0.01, scale=0.01))
    cfg = SimConfig(policy=make_policy("reactive"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VectorBatch(trace, [cfg])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VectorSimulation(trace, cfg)
    spec = StackSpec(models=PAPER_MODELS, regions=REGIONS,
                     scaler="reactive", drain_grace=900.0)
    stack = build_stack(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stack.simulate_vector(trace)
    exp = ExperimentSpec(name="x", strategies={"r": spec},
                         workloads={"w": WorkloadSpec(days=0.01,
                                                      scale=0.01)},
                         engine="vector")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment(exp, jobs=1)
    assert run_experiment(exp, jobs=1, device="cpu").results[0].engine \
        == "vector"


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v3-671b",
                                  "pixtral-12b", "whisper-tiny"])
def test_new_family_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda, arch):
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.serving.engine import ServingEngine

    cfg = reduce_for_smoke(get_arch(arch))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_decode_cache(cfg, 1, 8)
    lm = model.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, lm, max_batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--arch", arch])


def test_serve_refuses_weights_larger_than_the_free_memory():
    """``launch/serve.py`` compares the config's weight bytes with the
    card's free memory before allocating anything: full-size DeepSeek-V3
    (671 B params, 1.34 TB in bf16) on an 80 GB card fails with an error
    naming both, and no weight is drawn; Pixtral-12B (24.5 GB) passes
    the check.  ``mem_get_info`` is mocked, so this runs on the CPU."""
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    free = (79_000_000_000, 85_000_000_000)
    cuda = torch.device("cuda", 0)
    with mock.patch.object(torch.cuda, "mem_get_info", return_value=free):
        with pytest.raises(RuntimeError, match=r"1342\.\d GB .* 79\.0 GB"):
            serve.check_fits(get_arch("deepseek-v3-671b"), cuda)
        serve.check_fits(get_arch("pixtral-12b"), cuda)
        with mock.patch.object(serve, "resolve_device", return_value=cuda), \
                mock.patch.object(serve.model_mod, "init") as init:
            with pytest.raises(RuntimeError, match="GB free"):
                serve.main(["--arch", "deepseek-v3-671b"])
        init.assert_not_called()
    serve.check_fits(get_arch("deepseek-v3-671b"), torch.device("cpu"))
