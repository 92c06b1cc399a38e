"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains the reduced (``reduce_for_smoke``) variant of the chosen
architecture on synthetic data (``SyntheticLM``), or the full-size one
with ``--full``, with AdamW on a cosine schedule, as the reference's
launcher does.  It runs on CUDA unless ``--device cpu``.  Launched on
several ranks by ``torchrun`` (``RANK``/``WORLD_SIZE`` set), it opens
the process group (NCCL on cards, each rank on its ``LOCAL_RANK``'s;
gloo with ``--device cpu``) and ``train.loop.train`` places the
parameters, AdamW's moments and each batch by ``TRAIN_RULES`` on
``make_local_mesh()``, (world, 1), as the reference trains under
``axis_rules(make_local_mesh(), TRAIN_RULES)``; one rank runs unplaced.
Before drawing any weight it checks that one device's share of the
training state fits its free memory (:func:`check_fits`): the
parameters and their gradients in the model dtype plus AdamW's two fp32
moments, about 12 bytes a parameter in bf16, each leaf split as the
rules split it.

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --arch gemma-7b
"""
from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist.sharding import TRAIN_RULES, local_shape
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import model as model_mod
from repro_torch.models.layers import model_dtype
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW, cosine_schedule


def train_state_bytes(cfg: ModelConfig, mesh: Optional[Mesh] = None) -> int:
    """Parameters and gradients in the model dtype and AdamW's fp32 m and
    v: ``param_count() * (2 * itemsize + 8)``; on a ``mesh``, one
    device's share, each parameter's ``local_shape`` under
    ``TRAIN_RULES``."""
    per = 2 * model_dtype(cfg).itemsize + 8
    if mesh is None or mesh.size == 1:
        return cfg.param_count() * per
    lm = model_mod.module(cfg, torch.device("meta"))
    return per * sum(math.prod(local_shape(
        p.shape, TRAIN_RULES.spec(p.logical_axes, mesh), mesh))
        for p in lm.parameters())


def check_fits(cfg: ModelConfig, device: torch.device,
               mesh: Optional[Mesh] = None) -> None:
    """Raise unless one device's share of the config's training state
    fits the free memory of CUDA ``device``; no check on the CPU."""
    if device.type != "cuda":
        return
    need = train_state_bytes(cfg, mesh)
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise RuntimeError(
            f"{cfg.name}: its training state takes {need / 1e9:.1f} GB "
            f"({cfg.param_count():,} params in {cfg.dtype}, their gradients "
            f"and AdamW's fp32 moments) but {device} has {free / 1e9:.1f} "
            f"GB free; train the reduced variant (without --full)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="the full-size config (default: reduced)")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if launched:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        cfg = get_arch(args.arch)
        if not args.full:
            cfg = reduce_for_smoke(cfg)
        check_fits(cfg, dev, make_local_mesh() if launched else None)
        opt = AdamW(lr=cosine_schedule(args.lr,
                                       warmup=max(args.steps // 20, 1),
                                       total=args.steps))
        data = DataConfig(batch_size=args.batch, seq_len=args.seq)
        out = train(cfg, steps=args.steps, data=data, opt=opt,
                    ckpt_path=args.ckpt, remat=args.remat, device=dev,
                    verbose=not launched or dist.get_rank() == 0)
    finally:
        if launched:
            dist.destroy_process_group()
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
