"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Drives the continuous-batching :class:`ServingEngine` with a mixed
IW-F/IW-N request stream (every third request IW-F, TTFT deadlines
+2/+20 steps after arrival) and a SageServe scheduler (default DPA),
printing TTFT/E2E step counts, and each request's TTFT in ms (submit to
the return of the step that made its first token).  ``--arch`` takes every architecture of
``configs.ARCHS``: dense (``starcoder2-7b``, ``qwen2-72b``, ...), SSM and
hybrid (``mamba2-370m``, ``zamba2-7b``), MoE (``llama4-scout-17b-a16e``,
``deepseek-v3-671b`` with MLA), VLM (``pixtral-12b``) and audio
(``whisper-tiny``).  It serves the full-size architecture on CUDA by
default, after checking that its weights fit the card's free memory
(:func:`check_fits`: full-size DeepSeek-V3 does not fit one card, and
the launcher says so instead of running out of memory midway);
``--smoke`` selects the reduced variant and ``--device cpu`` runs on the
CPU.  Weights are random, drawn from a seeded generator.  It runs under
``torch.inference_mode()``: serving builds no autograd graph.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.models.layers import model_dtype
from repro_torch.serving.engine import ServeRequest, ServingEngine


def check_fits(cfg: ModelConfig, device: torch.device) -> None:
    """Raise unless the config's weights (``param_count()`` in its
    dtype) fit the free memory of CUDA ``device``; no check on the CPU."""
    if device.type != "cuda":
        return
    need = cfg.param_count() * model_dtype(cfg).itemsize
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise RuntimeError(
            f"{cfg.name}: its weights take {need / 1e9:.1f} GB "
            f"({cfg.param_count():,} params in {cfg.dtype}) but {device} "
            f"has {free / 1e9:.1f} GB free; serve the --smoke variant or a "
            f"smaller architecture")


def make_requests(cfg: ModelConfig, n: int, *, max_new: int,
                  prompt_len: Tuple[int, int] = (8, 32),
                  seed: int = 0) -> List[ServeRequest]:
    """The launcher's request mix: prompts of ``prompt_len`` [lo, hi)
    random tokens, IW-F every third request, deadlines +2 (IW-F) and +20
    (IW-N) after arrival i."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        tier = "IW-F" if i % 3 == 0 else "IW-N"
        reqs.append(ServeRequest(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, rng.integers(*prompt_len)),
            max_new_tokens=max_new, tier=tier, arrival=float(i),
            ttft_deadline=float(i) + (2 if tier == "IW-F" else 20)))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced (reduce_for_smoke) variant")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--scheduler", default="dpa",
                    choices=["fcfs", "edf", "pf", "dpa"])
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    check_fits(cfg, dev)
    params = model_mod.init(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    eng = ServingEngine(cfg, params, max_batch=args.max_batch, max_seq=256,
                        scheduler=args.scheduler, device=dev)
    reqs = make_requests(cfg, args.requests, max_new=args.max_new)
    for r in reqs:
        eng.submit(r)
    with torch.inference_mode():
        eng.run()
    for r in reqs:
        print(f"req {r.rid} [{r.tier}] ttft_step={r.ttft_step} "
              f"ttft_ms={r.ttft_s * 1e3:.1f} done_step={r.done_step} "
              f"tokens={len(r.tokens)}")
    if any(r.done_step is None for r in reqs):
        raise RuntimeError("some requests did not finish")
    print(f"served {len(reqs)} requests in {eng.step_count} engine steps "
          f"with {args.scheduler.upper()} scheduling on {cfg.name} ({dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
