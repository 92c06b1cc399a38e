"""Readings the benchmark's limits and rates were set from, on the card.

    python3 bench/calibrate.py check --workload <cell> --seeds 1,2,3 \
        --control 3 --seconds 30
    python3 bench/calibrate.py sweep --workload <cell> --seed 1 \
        --rates 2,4,6,8 --seconds 30 --warmup 20

``check`` runs the cell once per seed in one process, as ``run.py``
does, and prints for each the widest logit gap of the served tokens
and, for the first ``--control`` seeds, the control's: the fp8
reference's tokens at the same positions (``harness/check.py``).  The
limit in ``bench/limits/<cell>.json`` lies between the two.

``sweep`` sets the cell up once and then, for each interactive rate in
turn, runs ``--warmup`` steps and a window of ``--seconds`` at that
rate, and prints the IW TTFT percentiles and the output rate: the knee
is the highest rate whose IW TTFT p95 stays within IW-F's 1 s.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, setup_environment  # noqa: E402


def check(cell, args) -> None:
    from bench.harness import runner

    for i, seed in enumerate(args.seeds):
        t = time.perf_counter() if i else T_START
        out = runner.execute(ROOT, cell, seed, args.seconds, False, "cuda",
                             t, control=i < args.control)
        print(json.dumps({"seed": seed, "check": out["check"],
                          "metrics": out["metrics"], "info": out["info"],
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"]}),
              flush=True)


def sweep(cell, args) -> None:
    import torch

    from bench.harness import runner, serve, stats, traffic

    drv = runner.start(cell, args.seed, "cuda")
    for rate in args.rates:
        drv.arrivals = traffic.Arrivals(rate, args.seed)
        drv.start_iw()
        for _ in range(args.warmup):
            drv.step()
        torch.cuda.synchronize()
        w = serve.measure(drv, args.seconds)
        ttft = [w.ttft(tr) for tr in w.iw]
        print(json.dumps({
            "rate_per_s": rate, "iw_due": len(w.iw), "missing": w.missing(),
            "iw_ttft_p50_ms": stats.percentile(ttft, 50) * 1e3,
            "iw_ttft_p95_ms": stats.percentile(ttft, 95) * 1e3,
            "itl_p95_ms": stats.percentile(w.gaps(), 95) * 1e3,
            "output_tokens_per_s": stats.rate(w.tokens(), w.t_end - w.t0),
            "steps": len(w.steps),
            "admitted_per_step": sum(len(s.prompts) for s in w.steps)
            / len(w.steps),
            "queued_iw_at_close": sum(1 for tr in drv.live
                                      if tr.kind == "iw" and not tr.times)}),
            flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("check", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--rates",
                    type=lambda s: [float(x) for x in s.split(",")])
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seconds", type=float, default=30)
    args = ap.parse_args(argv)
    setup_environment()
    from bench.harness import spec
    cell = spec.load_cell(ROOT, args.workload)
    (check if args.mode == "check" else sweep)(cell, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
