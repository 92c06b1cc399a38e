"""The port's experiment layer and scenario fuzzer against repro's.

``repro_torch.api.experiment`` and ``repro_torch.workloads.fuzz`` are
copies of the reference's; the experiment layer adds a ``device``
argument (CUDA unless ``"cpu"``) that reaches ``build_stack`` and the
vector engine.  Held to:

- specs (``ExperimentSpec``, ``Variant``) serialise to the reference's
  dicts and round-trip through ``to_dict``/``from_dict``; a
  ``ResultSet`` round-trips and has the reference's keys;
- ``fuzz_scenarios`` yields the reference's scenario dicts, and
  ``fuzz_experiment`` its experiment, for the same seed;
- one quick fuzz scenario (composed: its axes include an outage
  window, which the vector engine applies at its boundaries) runs
  ``engine="vector"`` on the port within the run parity of
  ``tests/test_torch_vector.py``: completed and dropped counts equal,
  instance-hours and gpu_dollars within ``RUN_RTOL`` (measured: equal).
"""
import json

import pytest
import torch

from repro.api import StackSpec as RefStackSpec
from repro.api.experiment import ExperimentSpec as RefExperimentSpec
from repro.api.experiment import ResultSet as RefResultSet
from repro.api.experiment import Variant as RefVariant
from repro.api.experiment import run_experiment as ref_run_experiment
from repro.sim.workload import WorkloadSpec as RefWorkloadSpec
from repro.workloads import FuzzSpec as RefFuzzSpec
from repro.workloads import fuzz_experiment as ref_fuzz_experiment
from repro.workloads import fuzz_scenarios as ref_fuzz_scenarios
from repro_torch.api import (ExperimentSpec, ResultSet, StackSpec, Variant,
                             run_experiment)
from repro_torch.sim.workload import PAPER_MODELS, REGIONS, WorkloadSpec
from repro_torch.workloads import FuzzSpec, fuzz_experiment, fuzz_scenarios

torch.set_num_threads(1)

RUN_RTOL = 1e-4
TINY_WL = dict(days=0.05, scale=0.01, seed=2)
#: one composed scenario, steady-diurnal + an outage window + a
#: popularity shift, run by the reactive and chiron stacks in one batch
FUZZ = dict(seed=9, days=0.05, scale=0.01,
            families=("steady-diurnal", "flash-crowd"), include_pure=False,
            n_composed=1, stacks=("reactive", "chiron"))


def _stack(cls, scaler="reactive", **kw):
    return cls(models=PAPER_MODELS, regions=REGIONS, scaler=scaler,
               initial_instances=3, spot_spare=8, **kw)


def _specs(exp_cls, stack_cls, wl_cls, variant_cls):
    axes = exp_cls(
        name="exp", strategies={s: _stack(stack_cls, s)
                                for s in ("reactive", "lt-ua")},
        workloads={"tiny": wl_cls(**TINY_WL)}, seeds=(0, 1),
        profiles={"llama2-70b": "llama2-70b@a100"}, engine="vector")
    v = variant_cls(name="combined/aware", stack=_stack(stack_cls),
                    workload=wl_cls(**TINY_WL), strategy="aware",
                    workload_name="combined")
    return axes, exp_cls(name="placement", variants=(v,)), v


def test_specs_serialise_as_the_reference_and_round_trip():
    port = _specs(ExperimentSpec, StackSpec, WorkloadSpec, Variant)
    want = _specs(RefExperimentSpec, RefStackSpec, RefWorkloadSpec,
                  RefVariant)
    for got, ref in zip(port, want):
        d = got.to_dict()
        json.dumps(d)
        assert d == ref.to_dict()
        assert type(got).from_dict(d) == got
    assert port[1].expand() == (port[2],)
    with pytest.raises(KeyError, match="unknown Variant fields"):
        Variant.from_dict({**port[2].to_dict(), "nope": 1})


def test_fuzz_scenarios_equal_the_reference():
    got = fuzz_scenarios(FuzzSpec(seed=5, days=0.5, scale=0.01))
    want = ref_fuzz_scenarios(RefFuzzSpec(seed=5, days=0.5, scale=0.01))
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert len(got) > 7
    assert fuzz_experiment(FuzzSpec(**FUZZ)).to_dict() == \
        ref_fuzz_experiment(RefFuzzSpec(**FUZZ)).to_dict()


def test_fuzz_scenario_runs_vector_like_the_reference():
    exp = fuzz_experiment(FuzzSpec(**FUZZ))
    ref_exp = ref_fuzz_experiment(RefFuzzSpec(**FUZZ))
    assert exp.engine == "vector"
    assert all("+outage" in v.name for v in exp.variants)
    got = run_experiment(exp, jobs=1, device="cpu")
    want = ref_run_experiment(ref_exp, jobs=1)
    assert [r.variant for r in got] == [r.variant for r in want]
    assert ResultSet.from_dict(got.to_dict()) == got
    assert RefResultSet.from_dict(want.to_dict()) == want
    assert set(got.to_dict()) == set(want.to_dict())
    for g, w in zip(got, want):
        assert set(g.to_dict()) == set(w.to_dict())
        assert g.engine == w.engine == "vector"
        assert g.report["completed"] == w.report["completed"], g.variant
        assert g.report["dropped"] == w.report["dropped"], g.variant
        assert g.completed_total > 0
        assert g.total_instance_hours == pytest.approx(
            w.total_instance_hours, rel=RUN_RTOL)
        assert g.total_gpu_dollars == pytest.approx(
            w.total_gpu_dollars, rel=RUN_RTOL)
