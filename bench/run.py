"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The system under test is the PyTorch/CUDA port,
``repro_torch`` under ``src/``; nothing here imports JAX or the JAX
package.  The last line of standard output is one JSON object (see
``bench/harness/runner.py``); the numbers the check compared, each beside
its limit, are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is the port; an entry set to None
    blocks an import and is no module)."""
    loaded = {name.split(".")[0] for name, mod in list(sys.modules.items())
              if mod is not None}
    return sorted(loaded & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def setup_environment() -> None:
    """Keep every cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_environment()

    from bench.harness import spec
    cell = spec.load_cell(ROOT, args.workload)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2

    from bench.harness import runner
    out = runner.execute(ROOT, cell, args.seed, args.seconds,
                         bool(args.trace), "cuda", T_START)
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     **out["device"]}
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    print(f"card: {card()}", file=sys.stderr)
    chk = out["check"]["max_logit_gap"]
    print(f"max_logit_gap {chk['value']!r} limit {chk['limit']!r}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
