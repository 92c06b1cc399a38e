"""The port's workload generator and event-loop simulator against repro.

``repro_torch``'s substrate (``sim/``, ``workloads/``, ``core/``,
``api/``, ``control/`` but the forecast) is a verbatim copy of
``repro``'s with the imports rewritten, so everything here is held to
equality: trace columns bit for bit, Reports field for field at
``rel_tol = abs_tol = 1e-9`` (``tests/test_perf_equivalence.py``'s
``_compare``).  None of these stacks has a forecaster, so they touch no
device.
"""
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from repro.api import StackSpec as RefStackSpec
from repro.api import build_stack as ref_build_stack
from repro.sim import workload as ref_workload
from repro.sim.metrics import report_to_dict as ref_report_to_dict
from repro.workloads import FAMILIES as REF_FAMILIES
from repro.workloads import family_workload as ref_family_workload
from repro_torch.api import StackSpec, build_stack
from repro_torch.core.queue_manager import QueueManager
from repro_torch.core.scaling import make_policy
from repro_torch.sim import workload
from repro_torch.sim.metrics import report_to_dict
from repro_torch.sim.simulator import SimConfig, Simulation
from repro_torch.workloads import FAMILIES, family_workload

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"
COLUMNS = ("rid", "model_idx", "region_idx", "tier_idx", "arrival",
           "prompt_tokens", "output_tokens", "ttft_deadline", "deadline",
           "session")


def _compare(path, a, b, errs):
    """Field-for-field, floats at rel = abs = 1e-9 (as
    ``tests/test_perf_equivalence.py`` compares against the golden)."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            errs.append(f"{path}: key mismatch")
            return
        for k, v in b.items():
            _compare(f"{path}.{k}", a[k], v, errs)
    elif isinstance(b, list):
        if len(a) != len(b):
            errs.append(f"{path}: length {len(a)} != {len(b)}")
            return
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(f"{path}[{i}]", x, y, errs)
    elif isinstance(b, float) and isinstance(a, (int, float)):
        if not math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9):
            errs.append(f"{path}: {a} != {b}")
    elif a != b:
        errs.append(f"{path}: {a!r} != {b!r}")


def _assert_traces_equal(got, want):
    assert (got.models, got.regions, got.tiers) == (want.models,
                                                    want.regions, want.tiers)
    for col in COLUMNS:
        a, b = getattr(got, col), getattr(want, col)
        if b is None:
            assert a is None, col
            continue
        assert a.dtype == b.dtype, col
        np.testing.assert_array_equal(a, b, err_msg=col)


def test_family_catalog_matches_reference():
    assert sorted(FAMILIES) == sorted(REF_FAMILIES)
    for name in FAMILIES:
        assert FAMILIES[name].to_dict() == REF_FAMILIES[name].to_dict()


def test_default_trace_bit_equal():
    spec = dict(days=0.5, scale=0.02, seed=0)
    _assert_traces_equal(
        workload.generate_trace(workload.WorkloadSpec(**spec)),
        ref_workload.generate_trace(ref_workload.WorkloadSpec(**spec)))


@pytest.mark.parametrize("family", sorted(REF_FAMILIES))
def test_family_trace_bit_equal(family):
    """Every workload family, the ``session`` column included."""
    got = workload.generate_trace(
        family_workload(family, days=0.2, scale=0.005, seed=3))
    want = ref_workload.generate_trace(
        ref_family_workload(family, days=0.2, scale=0.005, seed=3))
    assert len(want) > 100
    _assert_traces_equal(got, want)


def test_golden_report_reproduced():
    """``tests/golden/report_small.json`` field for field, on the pinned
    trace and the reactive stack of ``test_perf_equivalence._golden_cfg``."""
    trace = workload.replay_csv(str(GOLDEN / "trace_small.csv.gz"))
    cfg = SimConfig(policy=make_policy("reactive"),
                    queue_manager=QueueManager(),
                    initial_instances=3, spot_spare=8,
                    drain_grace=3 * 3600.0)
    rep = report_to_dict(Simulation(trace, cfg, name="golden").run())
    gold = json.loads((GOLDEN / "report_small.json").read_text())
    errs = []
    _compare("report", rep, gold, errs)
    assert not errs, errs[:10]


def _stack_dict(strategy):
    """The reference benchmark's reactive and chiron stacks
    (``benchmarks/common.py:stack_spec``, initial_instances 5, spot_spare
    30, FCFS), written out."""
    common = dict(models=list(workload.PAPER_MODELS),
                  regions=list(workload.REGIONS), scheduler="fcfs",
                  spot_spare=30)
    if strategy == "chiron":
        return dict(scaler={"name": "chiron", "kwargs": {
            "theta": 0.6, "init_interactive": 3, "init_mixed": 1,
            "init_batch": 1}}, initial_instances=None, **common)
    return dict(scaler="reactive", initial_instances=5, **common)


@pytest.mark.parametrize("strategy", ["reactive", "chiron"])
def test_stack_report_equals_reference(strategy):
    spec = dict(days=0.03, scale=0.01)
    stack = build_stack(StackSpec.from_dict(_stack_dict(strategy)))
    ref = ref_build_stack(RefStackSpec.from_dict(_stack_dict(strategy)))
    assert stack.spec.to_dict() == ref.spec.to_dict()
    got = report_to_dict(stack.simulate(
        workload.generate(workload.WorkloadSpec(**spec)), name=strategy))
    want = ref_report_to_dict(ref.simulate(
        ref_workload.generate(ref_workload.WorkloadSpec(**spec)),
        name=strategy))
    assert sum(want["completed"].values()) > 0
    errs = []
    _compare("report", got, want, errs)
    assert not errs, errs[:10]


def test_simulate_vector_names_the_roadmap_item():
    stack = build_stack(StackSpec.from_dict(_stack_dict("reactive")))
    with pytest.raises(NotImplementedError, match="vector engine"):
        stack.simulate_vector(workload.generate_trace(
            workload.WorkloadSpec(days=0.01, scale=0.01)))
