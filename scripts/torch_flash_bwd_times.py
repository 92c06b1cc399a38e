#!/usr/bin/env python3
"""K2's backward timed at ``chip_smoke.py``'s ``bwd_row`` shapes, for one checkout of the repository (one CUDA device).

    python3 scripts/torch_flash_bwd_times.py [--tree DIR] [--reps 20]

Builds the attention kernels of ``DIR/src/repro_torch`` (by default the
checkout this script lies in) into ``DIR/build/``, then times
``flash_attention_bwd`` of that tree with ``chip_smoke.time_ms`` (CUDA
events, the L2 flushed before each launch) and each of its kernels'
device time (``chip_smoke.bwd_kernel_times``) at the trained and served
widths, on inputs made from one seed.  A shape the tree's wrapper does
not take (V at its own head dim before K2 had one) is reported as such.
Two trees timed in turns in one call (parent, change, change, parent)
compare two versions on one card.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

#: (label, B, H, Hkv, S, T, hd, vd, causal): chip_smoke.time_kernels'
#: bwd_row shapes
SHAPES = (
    ("starcoder2-7b train", 2, 36, 4, 2048, 2048, 128, None, True),
    ("zamba2-7b shared block", 1, 32, 32, 2000, 2000, 112, None, True),
    ("deepseek-v3-671b MLA", 1, 128, 128, 2000, 2000, 192, 128, True),
    ("stablelm-12b", 1, 32, 8, 2048, 2048, 160, None, True),
    ("gemma-7b", 1, 16, 16, 2048, 2048, 256, None, True),
    ("whisper-tiny encoder", 1, 6, 6, 1500, 1500, 64, None, False),
    ("whisper-tiny cross", 1, 6, 6, 2000, 1500, 64, None, False),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    # the tree's package first: chip_smoke's own src comes after it
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    print(f"{cs.smi_line()} | tree {tree}", flush=True)
    _build.build_all(["flash_attention", "flash_attention_bwd_bf16"])
    flush = cs.L2Flush(dev)
    bf16 = torch.bfloat16
    for label, B, H, Hkv, S, T, hd, vd, causal in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(1)
        (q, k, v, qpos, kpos), opts = cs.flash_case(
            dev, bf16, gen, B, H, Hkv, S, T, hd, causal=causal, vd=vd)
        try:
            out, lse = fa.flash_attention(q, k, v, qpos, kpos,
                                          return_lse=True, **opts)
        except ValueError as e:
            print(f"  {label}: not taken by this tree ({e})", flush=True)
            continue
        do = cs.randn(dev, (B, S, H, vd or hd), bf16, gen).transpose(1, 2)
        grads = (q, k, v, out, lse, do, qpos, kpos)

        def call():
            return fa.flash_attention_bwd(*grads, **opts)

        ms = cs.time_ms(call, flush, reps=args.reps)
        kernels = cs.bwd_kernel_times(call)
        print(f"  {label}: B={B} H={H} Hkv={Hkv} S={S} T={T} hd={hd}"
              + (f" V {vd}" if vd else "") + f": {ms:.4f} ms ("
              + ", ".join(f"{n} {t:.4f}" for n, t in kernels.items())
              + ")", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
