"""The port's ``lt-ua+plan`` stack against the JAX package's recorded plans.

``tests/golden/lt_ua_plan_plans.json`` holds the reference's 53 hourly
plans (time, the 12 ILP targets, the forecast peaks they were planned
for) and its Report on the generated 2-day trace of
``tests/test_torch_control.py``'s ``test_lt_ua_plan_report_and_ilp_flips``
(``days=2.0, scale=0.005, seed=7``), written by
``scripts/torch_plan_fixture.py``.  This file imports neither JAX nor
``repro``, so a host without them (the card's) holds the port to the
same bounds as that test: at most ``MAX_FLIPS`` targets flipped, GPU
instance-hours per endpoint and dollars within ``HOURS_RTOL``, SLA
violation fractions per tier within ``SLA_ATOL``.  The flips counted
are printed (run with ``-s``).
"""
import json
import math
import pathlib

import torch

from repro_torch.api import PolicySpec, StackSpec, build_stack
from repro_torch.control import amortize, forecast
from repro_torch.sim import workload
from repro_torch.sim.metrics import report_to_dict

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "golden" / "lt_ua_plan_plans.json"

#: tests/test_torch_control.py's bounds
MAX_FLIPS = 6            # 1% of 636 targets
HOURS_RTOL = 1e-2
SLA_ATOL = 5e-3

#: the workload and stack the fixture records (held equal to it below)
WORKLOAD = dict(days=2.0, scale=0.005, seed=7)
STACK = dict(scaler="lt-ua", router="plan", initial_instances=3,
             spot_spare=8, scheduler="fcfs")
PLANNER = {"kind": "sageserve",
           "params": {"min_instances": 2, "epsilon": 0.8, "fit_steps": 150,
                      "theta_headroom": 0.7, "use_routing": True}}


def _key(key) -> str:
    model, region = key
    return f"{model}|{region}"


def test_lt_ua_plan_against_the_recorded_reference():
    want = json.loads(FIXTURE.read_text())
    assert (want["workload"], want["stack"], want["planner"]) == (
        WORKLOAD, STACK, PLANNER)
    forecast.clear_fit_cache()
    amortize.clear_solve_cache()
    stack = build_stack(StackSpec(
        models=workload.PAPER_MODELS, regions=workload.REGIONS,
        planner=PolicySpec(PLANNER["kind"], dict(PLANNER["params"])),
        **STACK), device="cpu")
    plans, plan = [], stack.planner.plan

    def recorded(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    stack.planner.plan = recorded
    try:
        got = report_to_dict(stack.simulate(workload.generate(
            workload.WorkloadSpec(**WORKLOAD)), name="lt-ua+plan"),
            include_util_trace=False)
    finally:
        forecast.clear_fit_cache()
        amortize.clear_solve_cache()

    assert len(plans) == len(want["plans"]) == 53     # boundaries, 0-52 h
    assert stack.planner.engine.unique_fits > 0
    targets, flipped, peak_rel = 0, [], 0.0
    for p, r in zip(plans, want["plans"]):
        mine = {_key(k): n for k, n in p.targets.items()}
        peaks = {_key(k): f for k, f in p.forecasts.items()}
        assert p.t == r["t"] and set(mine) == set(r["targets"])
        for key, n in r["targets"].items():
            targets += 1
            if mine[key] != n:
                flipped.append((p.t / 3600, key, mine[key], n))
            peak_rel = max(peak_rel, abs(peaks[key] - r["forecasts"][key])
                           / max(abs(r["forecasts"][key]), 1.0))
    print(f"lt-ua+plan against the fixture ({want['made_by']}): "
          f"{len(flipped)} of {targets} ILP targets flipped (hour, key, "
          f"port, reference: {flipped}); largest forecast peak difference "
          f"rel {peak_rel:.3e}; instance hours "
          f"{sum(got['instance_hours'].values()):.6f} vs "
          f"{sum(want['report']['instance_hours'].values()):.6f}")
    assert targets == 53 * 12
    assert len(flipped) <= MAX_FLIPS, f"{len(flipped)} ILP targets flipped"

    ref = want["report"]
    for key, hours in ref["instance_hours"].items():
        assert math.isclose(got["instance_hours"][key], hours,
                            rel_tol=HOURS_RTOL), key
    for tier, frac in ref["sla_violations"].items():
        assert abs(got["sla_violations"][tier] - frac) <= SLA_ATOL, tier
    assert math.isclose(got["gpu_dollars_total"], ref["gpu_dollars_total"],
                        rel_tol=HOURS_RTOL)
