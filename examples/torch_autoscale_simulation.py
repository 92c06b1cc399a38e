"""Full strategy shoot-out on the PyTorch port: Siloed / Reactive / LT-I / LT-U /
LT-UA / LT-UA+plan-routing / Chiron — the shape of Fig. 8 + Fig. 11 of
the paper, with dollar-cost columns (α = $98.32/h, §7.2.1).

Counterpart of ``examples/autoscale_simulation.py`` on ``repro_torch``.
The reference builds its strategies with ``benchmarks.common``, which
imports jax, so the seven stacks of ``benchmarks.common.stack_spec`` at
``BenchSpec()``'s defaults (5 initial instances, 30 spot spares, FCFS,
the planner's 0.7 capacity derating) are written out here.  The sweep
is one ``ExperimentSpec`` run by the parallel experiment runner;
``--jobs N`` fans the strategies out over N worker processes, ``--out``
persists the JSON result artifact, and the forecast fits run on
``--device`` (default: cuda).

    PYTHONPATH=src python examples/torch_autoscale_simulation.py [--scale 0.15]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch import resolve_device
from repro_torch.api import ExperimentSpec, PolicySpec, StackSpec
from repro_torch.api.experiment import run_experiment
from repro_torch.sim.workload import PAPER_MODELS, REGIONS, WorkloadSpec

STRATEGIES = ("siloed", "reactive", "lt-i", "lt-u", "lt-ua", "lt-ua+plan",
              "chiron")
INITIAL_INSTANCES = 5


def planner(routing: bool = False) -> PolicySpec:
    kw = {"min_instances": 2, "epsilon": 0.8, "fit_steps": 150,
          "theta_headroom": 0.7}
    if routing:
        kw["use_routing"] = True
    return PolicySpec("sageserve", kw)


def strategies():
    common = dict(models=tuple(PAPER_MODELS), regions=tuple(REGIONS),
                  scheduler="fcfs", spot_spare=30)
    out = {
        "siloed": StackSpec(scaler="reactive", queue=None, siloed=True,
                            siloed_iw=max(INITIAL_INSTANCES - 1, 2),
                            siloed_niw=2,
                            initial_instances=INITIAL_INSTANCES, **common),
        "chiron": StackSpec(scaler=PolicySpec("chiron", {
            "theta": 0.6, "init_interactive": max(INITIAL_INSTANCES - 2, 2),
            "init_mixed": 1, "init_batch": 1}),
            initial_instances=None, **common),
        "lt-ua+plan": StackSpec(scaler="lt-ua", planner=planner(True),
                                router="plan",
                                initial_instances=INITIAL_INSTANCES,
                                **common)}
    for s in ("reactive", "lt-i", "lt-u", "lt-ua"):
        out[s] = StackSpec(scaler=s,
                           planner=None if s == "reactive" else planner(),
                           initial_instances=INITIAL_INSTANCES, **common)
    return {s: out[s] for s in STRATEGIES}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--days", type=float, default=1.0)
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker processes (default: CPU count)")
    ap.add_argument("--out", default=None, metavar="RESULTS.json",
                    help="persist the result artifact")
    ap.add_argument("--device", default=None,
                    help="where the forecast fits run (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    exp = ExperimentSpec(
        name="autoscale", strategies=strategies(),
        workloads={"default": WorkloadSpec(days=args.days, scale=args.scale,
                                           seed=0,
                                           models=tuple(PAPER_MODELS))})
    results = run_experiment(exp, jobs=args.jobs, out=args.out, device=dev)

    n = results.results[0].n_requests
    print(f"{n} requests, {args.days} day(s), scale {args.scale}, "
          f"fits on {dev}\n")
    deltas = results.deltas(baseline="reactive")
    print("=== instance-hours & dollars vs Unified Reactive ===")
    print(f"  {'strategy':10s} {'inst-h':>9s} {'gpu-$':>11s} "
          f"{'IW-F viol':>9s} {'savings':>16s}")
    for res in results:
        name = res.strategy
        d = deltas.get(res.variant)
        sav = (f"${d['gpu_dollars']['delta']:9,.0f} "
               f"({d['instance_hours']['pct']:+.1f}%)" if d else
               f"{'—':>16s}")
        print(f"  {name:10s} {res.total_instance_hours:8.1f}h "
              f"${res.total_gpu_dollars:10,.0f} "
              f"{res.sla_violations.get('IW-F', 0.0):8.1%} {sav}")
    if args.out:
        print(f"\nresult artifact: {args.out}")


if __name__ == "__main__":
    main()
