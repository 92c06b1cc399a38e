"""The port's ILP solvers and its full ``lt-ua+plan`` stack against repro.

The solvers (``control/{ilp,provision,amortize}``) are verbatim copies
on scipy/HiGHS, so they are held to equality on seeded random problems.
The ``lt-ua+plan`` stack (LT-UA scaling, the routing-aware ``sageserve``
ILP, the ``plan`` router; ``benchmarks/common.py:stack_spec``) also runs
the forecast fit, which rounds apart from the reference's and, at the
planner's 150 Adam steps, lands elsewhere on sparse series
(``tests/test_torch_forecast.py``).  A changed forecast peak can flip an
ILP instance target, so the test counts the flips over every hourly
plan and prints them.  Measured on the CPU, on
``tests/test_control_parity.py``'s 2-day ``scale=0.005, seed=7`` trace,
with the fit's blocked-scan order: 3 of the 53 x 12 targets flip
(bloom-176b in eastus at hour 15, in centralus at hour 33 and in westus
at hour 52: sparse series where one warm-started fit chain drifts to an
unstable forecast; the sequential order before it also flipped 3), and
the Reports still agree field for field.  Held to: at most 1% of targets flipped (``MAX_FLIPS``), GPU
instance-hours per endpoint and dollars within rel 1% (``HOURS_RTOL``), SLA
violation fractions per tier within 0.005 (``SLA_ATOL``).
"""
import math

import numpy as np
import pytest
import torch

from repro.api import PolicySpec as RefPolicySpec
from repro.api import StackSpec as RefStackSpec
from repro.api import build_stack as ref_build_stack
from repro.control import amortize as ref_amortize
from repro.control import forecast as ref_forecast
from repro.control import ilp as ref_ilp
from repro.control import provision as ref_provision
from repro.sim import workload as ref_workload
from repro.sim.metrics import report_to_dict as ref_report_to_dict
from repro_torch.api import PolicySpec, StackSpec, build_stack
from repro_torch.control import amortize, forecast, ilp, provision
from repro_torch.sim import workload
from repro_torch.sim.metrics import report_to_dict

torch.set_num_threads(1)

MAX_FLIPS = 6            # 1% of 636 targets; measured 3
HOURS_RTOL = 1e-2        # measured 0
SLA_ATOL = 5e-3          # measured 0


def _problem(mod, seed, l=3, r=3, g=1):
    rng = np.random.default_rng(seed)
    return mod.ProvisionProblem(
        n=rng.integers(2, 12, (l, r, g)).astype(float),
        theta=rng.uniform(800, 4000, (l, g)),
        alpha=rng.uniform(50, 120, (g,)),
        sigma=rng.uniform(5, 30, (l, g)),
        rho_peak=rng.uniform(2000, 40000, (l, r)),
        epsilon=0.8, region_cap=np.full(r, 600.0), min_instances=2,
        buffer=rng.uniform(0, 500, (l, r)))


def _assert_same_solution(got, want):
    assert got.status == want.status
    assert got.objective == want.objective
    np.testing.assert_array_equal(got.delta, want.delta)
    for name in ("omega", "y"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_provision_solvers_equal_reference(seed):
    """``solve`` and ``solve_with_routing`` (``provision.py:210, :296``),
    and the amortized cache in front of both."""
    got, want = _problem(provision, seed), _problem(ref_provision, seed)
    _assert_same_solution(provision.solve(got), ref_provision.solve(want))
    _assert_same_solution(provision.solve_with_routing(got),
                          ref_provision.solve_with_routing(want))
    amortize.clear_solve_cache()
    ref_amortize.clear_solve_cache()
    for routing in (False, True):
        _assert_same_solution(
            amortize.solve_amortized(got, use_routing=routing),
            ref_amortize.solve_amortized(want, use_routing=routing))
    amortize.clear_solve_cache()
    ref_amortize.clear_solve_cache()


@pytest.mark.parametrize("backend", ["milp", "bnb"])
@pytest.mark.parametrize("seed", range(3))
def test_solve_ilp_equals_reference(seed, backend):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, 6)
    a_ub = rng.uniform(-1, 3, (4, 6))
    b_ub = rng.uniform(5, 20, 4)
    kw = dict(A_ub=a_ub, b_ub=b_ub, bounds=[(0, 10)] * 6, backend=backend,
              max_nodes=5000)
    got, want = ilp.solve_ilp(c, **kw), ref_ilp.solve_ilp(c, **kw)
    assert (got.status, got.objective, got.nodes, got.gap) == (
        want.status, want.objective, want.nodes, want.gap)
    np.testing.assert_array_equal(got.x, want.x)


def test_stack_with_forecaster_defaults_to_cuda():
    """``build_stack`` resolves the device where the planner builds its
    forecast engine: CUDA unless asked, raising without it; a stack
    without a forecaster touches no device."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    spec = StackSpec(models=workload.PAPER_MODELS, regions=workload.REGIONS,
                     scaler="lt-ua", planner="sageserve")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_stack(spec)
    stack = build_stack(spec, device="cpu")
    assert stack.planner.engine.device == torch.device("cpu")
    build_stack(StackSpec(models=workload.PAPER_MODELS,
                          regions=workload.REGIONS, scaler="reactive"))


def _lt_ua_plan(spec_cls, policy_cls):
    """``benchmarks/common.py:stack_spec(BenchSpec(initial_instances=3,
    spot_spare=8), "lt-ua+plan")``, written out."""
    return spec_cls(
        models=workload.PAPER_MODELS, regions=workload.REGIONS,
        scaler="lt-ua", router="plan", initial_instances=3, spot_spare=8,
        scheduler="fcfs",
        planner=policy_cls("sageserve", {
            "min_instances": 2, "epsilon": 0.8, "fit_steps": 150,
            "theta_headroom": 0.7, "use_routing": True}))


def _recorded(stack):
    """Log every Plan the stack's planner emits."""
    plans, plan = [], stack.planner.plan

    def record(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    stack.planner.plan = record
    return plans


def test_lt_ua_plan_report_and_ilp_flips():
    spec = dict(days=2.0, scale=0.005, seed=7)
    forecast.clear_fit_cache()
    ref_forecast.clear_fit_cache()
    amortize.clear_solve_cache()
    ref_amortize.clear_solve_cache()
    stack = build_stack(_lt_ua_plan(StackSpec, PolicySpec), device="cpu")
    ref = ref_build_stack(_lt_ua_plan(RefStackSpec, RefPolicySpec))
    plans, ref_plans = _recorded(stack), _recorded(ref)
    got = report_to_dict(stack.simulate(
        workload.generate(workload.WorkloadSpec(**spec)), name="lt-ua+plan"))
    want = ref_report_to_dict(ref.simulate(
        ref_workload.generate(ref_workload.WorkloadSpec(**spec)),
        name="lt-ua+plan"))

    assert len(plans) == len(ref_plans) == 53       # boundaries, 0-52 h
    assert stack.planner.engine.unique_fits > 0
    targets, flipped = 0, []
    peak_rel = 0.0
    for p, r in zip(plans, ref_plans):
        assert p.t == r.t and set(p.targets) == set(r.targets)
        for key, n in r.targets.items():
            targets += 1
            if p.targets[key] != n:
                flipped.append((p.t / 3600, key, p.targets[key], n))
            peak_rel = max(peak_rel, abs(p.forecasts[key] - r.forecasts[key])
                           / max(abs(r.forecasts[key]), 1.0))
    flips = len(flipped)
    print(f"lt-ua+plan: {flips} of {targets} ILP targets flipped "
          f"(hour, key, port, reference: {flipped}); largest "
          f"forecast peak difference rel {peak_rel:.3e}; instance hours "
          f"{sum(got['instance_hours'].values()):.6f} vs "
          f"{sum(want['instance_hours'].values()):.6f}")
    assert targets == 53 * 12
    assert flips <= MAX_FLIPS, f"{flips} ILP targets flipped"

    for key, hours in want["instance_hours"].items():
        assert math.isclose(got["instance_hours"][key], hours,
                            rel_tol=HOURS_RTOL), key
    for tier, frac in want["sla_violations"].items():
        assert abs(got["sla_violations"][tier] - frac) <= SLA_ATOL, tier
    assert math.isclose(got["gpu_dollars_total"], want["gpu_dollars_total"],
                        rel_tol=HOURS_RTOL)
    forecast.clear_fit_cache()
    ref_forecast.clear_fit_cache()
    amortize.clear_solve_cache()
    ref_amortize.clear_solve_cache()
