"""Quickstart on the PyTorch port: the SageServe control loop via the declarative API.

Counterpart of ``examples/quickstart.py`` on ``repro_torch``.  Describes
two serving stacks as ``StackSpec``s — the Unified Reactive baseline
and the forecast+ILP LT-UA pipeline — builds each with ``build_stack``,
runs them over a small synthetic trace on the event-loop simulator
(the LT-UA planner's ARIMA fits run on the device, CUDA unless
``--device cpu``), and prints the savings.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch import resolve_device
from repro_torch.api import PolicySpec, StackSpec, build_stack
from repro_torch.sim.workload import (PAPER_MODELS, REGIONS, WorkloadSpec,
                                      generate)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the forecast fits run (default: cuda)")
    ap.add_argument("--days", type=float, default=1.0)
    ap.add_argument("--scale", type=float, default=0.1)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    trace = generate(WorkloadSpec(days=args.days, scale=args.scale, seed=0))
    print(f"trace: {len(trace)} requests over {args.days:g} day(s), "
          f"4 models, 3 regions; fits on {dev}")

    specs = {
        "reactive": StackSpec(models=PAPER_MODELS, regions=REGIONS,
                              scaler="reactive",
                              initial_instances=4, spot_spare=16),
        "lt-ua": StackSpec(models=PAPER_MODELS, regions=REGIONS,
                           scaler="lt-ua",
                           planner=PolicySpec("sageserve",
                                              {"min_instances": 2,
                                               "fit_steps": 120}),
                           initial_instances=4, spot_spare=16),
    }
    reports = {}
    for name, spec in specs.items():
        reports[name] = build_stack(spec, device=dev).simulate(trace,
                                                               name=name)
        print(reports[name].summary())

    base, ours = reports["reactive"], reports["lt-ua"]
    sav = 100 * (1 - ours.total_instance_hours()
                 / base.total_instance_hours())
    waste = 100 * (1 - ours.total_wasted_hours()
                   / max(base.total_wasted_hours(), 1e-9))
    dollars = ours.savings_vs(base)
    print(f"\nSageServe LT-UA vs Reactive: {sav:.1f}% fewer instance-hours, "
          f"{waste:.1f}% less GPU time wasted on scaling, "
          f"${dollars['dollars']:,.0f} saved ({dollars['pct']:.1f}%)")


if __name__ == "__main__":
    main()
