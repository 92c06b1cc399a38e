"""Record the JAX package's hourly plans and Report as the port's fixture.

    PYTHONPATH=src python scripts/torch_plan_fixture.py [--out PATH]

Runs the reference's ``lt-ua+plan`` stack (``repro``, on JAX) over the
generated 2-day trace of ``tests/test_torch_control.py``'s
``test_lt_ua_plan_report_and_ilp_flips`` (``days=2.0, scale=0.005,
seed=7``; nothing is downloaded) and writes, as JSON (default
``tests/golden/lt_ua_plan_plans.json``): the workload and stack it ran,
each of the 53 hourly plans' time, its 12 ILP targets and the forecast
peaks they were planned for, keyed "model|region", the Report
(``report_to_dict`` without the utilisation trace), and the versions of
the libraries that made them.  ``tests/test_torch_control_fixture.py``
holds the port to it on any host, without JAX.
"""
import argparse
import json
import pathlib
import platform

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "golden" / "lt_ua_plan_plans.json"

#: the trace, and ``benchmarks/common.py:stack_spec(BenchSpec(
#: initial_instances=3, spot_spare=8), "lt-ua+plan")`` written out, as
#: ``tests/test_torch_control.py:_lt_ua_plan`` has it
WORKLOAD = dict(days=2.0, scale=0.005, seed=7)
STACK = dict(scaler="lt-ua", router="plan", initial_instances=3,
             spot_spare=8, scheduler="fcfs")
PLANNER = ("sageserve", {"min_instances": 2, "epsilon": 0.8,
                         "fit_steps": 150, "theta_headroom": 0.7,
                         "use_routing": True})


def _key(key) -> str:
    model, region = key
    return f"{model}|{region}"


def record() -> dict:
    import jax
    import numpy
    import scipy

    from repro.api import PolicySpec, StackSpec, build_stack
    from repro.control import amortize, forecast
    from repro.sim import workload
    from repro.sim.metrics import report_to_dict

    forecast.clear_fit_cache()
    amortize.clear_solve_cache()
    stack = build_stack(StackSpec(
        models=workload.PAPER_MODELS, regions=workload.REGIONS,
        planner=PolicySpec(PLANNER[0], PLANNER[1]), **STACK))
    plans, plan = [], stack.planner.plan

    def recorded(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    stack.planner.plan = recorded
    report = stack.simulate(workload.generate(workload.WorkloadSpec(
        **WORKLOAD)), name="lt-ua+plan")
    return {
        "workload": WORKLOAD, "stack": STACK,
        "planner": {"kind": PLANNER[0], "params": PLANNER[1]},
        "made_by": {"package": "repro", "jax": jax.__version__,
                    "numpy": numpy.__version__, "scipy": scipy.__version__,
                    "python": platform.python_version()},
        "plans": [{"t": p.t,
                   "targets": {_key(k): n for k, n in p.targets.items()},
                   "forecasts": {_key(k): f
                                 for k, f in p.forecasts.items()}}
                  for p in plans],
        "report": report_to_dict(report, include_util_trace=False)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    args = ap.parse_args(argv)
    fixture = record()
    args.out.write_text(json.dumps(fixture, indent=1, sort_keys=True) + "\n")
    print(f"{len(fixture['plans'])} plans, "
          f"{sum(len(p['targets']) for p in fixture['plans'])} targets -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
