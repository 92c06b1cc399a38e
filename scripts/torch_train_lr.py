#!/usr/bin/env python3
"""The loss of ``chip_smoke.py``'s training runs at other peak learning rates (one CUDA device).

    python3 scripts/torch_train_lr.py [--arch starcoder2-7b]
                                      [--lr 1e-5,3e-5,1e-4,2e-4,5e-4]

Runs ``chip_smoke.train_run`` (``train.loop.train`` at full width, the
depth, batch, sequence length, steps and remat of ``chip_smoke.TRAINED``)
once per peak learning rate, with no step profiled; it prints each
step's loss, gradient norm and time.  A run whose loss does not fall is
reported, not raised.  It shows why ``chip_smoke.py`` trains each model
at its peak lr: AdamW's first step moves every weight by about lr.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-7b",
                    choices=[t[0] for t in chip_smoke.TRAINED])
    ap.add_argument("--lr", default="1e-5,3e-5,1e-4,2e-4,5e-4",
                    help="comma-separated peak learning rates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_lr: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi_line(), flush=True)
    run = next(t for t in chip_smoke.TRAINED if t[0] == args.arch)
    chip_smoke.PROFILED_STEP = -1                    # profile no step
    for lr in (float(x) for x in args.lr.split(",")):
        print(f"== {args.arch}, peak lr {lr:g}", flush=True)
        try:
            chip_smoke.train_run(dev, *run[:-1], lr)
        except SystemExit as e:
            print(f"  {e}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
