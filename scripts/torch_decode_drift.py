#!/usr/bin/env python3
"""How far the port's decode path drifts from a full forward, and why (one CUDA device).

    python3 scripts/torch_decode_drift.py [--arch zamba2-7b] [--tokens 1862]
                                          [--steps 1,31]

Builds the architecture at full size with seeded random weights, as
``chip_smoke.py`` does, and for one prompt of N random tokens prints the
relative L2 distance between last-position logits of:

- ``floor``: a forward over N tokens against a forward over N + 1
  (position N - 1 of each).  The math is the same; only the GEMM tiling
  and reduction orders that the two lengths pick differ.
- ``decode k``: a prefill of N - k tokens and k decode steps over the
  next tokens (teacher forced) against the forward over N, as
  ``chip_smoke.py`` checks a served request after k = 31 steps.
- ``decode k, plain attention``: the same with both attention kernels
  replaced by their plain versions, which keep the softmax weights in
  fp32 on both paths (the bf16 prefill kernel rounds them to bf16 for
  its tensor-core P V product; the decode kernel does not).
- ``decode k, fp32``: the same model in fp32 weights.

The last line is one JSON object with every number.  Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serving.engine import _write_slot  # noqa: E402


def rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


@contextlib.contextmanager
def plain_attention():
    """Both attention ops through their plain versions, on any device."""
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention = ref.flash_attention_ref
    ops.decode_attention = ref.decode_attention_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def last_forward(cfg, params, toks):
    return model.forward(cfg, params, {"tokens": toks})[0][0, -1]


def last_decode(cfg, params, toks, k, dev):
    """Prefill all but the last k tokens, then decode them one by one."""
    N = toks.shape[1]
    _, pre, _ = model.forward(cfg, params, {"tokens": toks[:, :N - k]},
                              return_cache=True)
    cache = model.init_decode_cache(cfg, 1, N + 8, device=dev)
    _write_slot(cache, pre, 0)
    for t in range(N - k, N):
        pos = torch.tensor([t], dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(cfg, params, toks[:, t:t + 1],
                                          cache, pos)
    return logits[0, 0]


def measure(cfg, params, toks, steps, dev, label, out):
    want = last_forward(cfg, params, toks)
    for k in steps:
        out[f"decode {k}{label}"] = rel(last_decode(cfg, params, toks, k,
                                                    dev), want)
        print(f"  decode {k}{label}: rel L2 {out[f'decode {k}{label}']:.3e}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--tokens", type=int, default=1862)
    ap.add_argument("--steps", default="1,31")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_drift: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    steps = [int(k) for k in args.steps.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{args.arch} on {smi}, N = {args.tokens}", flush=True)

    cfg = get_arch(args.arch)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, args.tokens + 1))).to(dev)
    out = {}
    with torch.no_grad():
        params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        out["floor"] = rel(
            model.forward(cfg, params, {"tokens": toks})[0][0, -2],
            last_forward(cfg, params, toks[:, :-1]))
        print(f"  floor: rel L2 {out['floor']:.3e}", flush=True)
        toks = toks[:, :-1]
        measure(cfg, params, toks, steps, dev, "", out)
        with plain_attention():
            measure(cfg, params, toks, steps, dev, ", plain attention", out)
        del params
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params = model.init(cfg32, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        measure(cfg32, params, toks, steps, dev, ", fp32", out)
    print(json.dumps({"arch": args.arch, "device": smi,
                      "tokens": args.tokens, "rel_l2": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
