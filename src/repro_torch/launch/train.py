"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains the reduced (``reduce_for_smoke``) variant of the chosen
architecture on synthetic data (``SyntheticLM``), or the full-size one
with ``--full``, with AdamW on a cosine schedule, as the reference's
launcher does.  It runs on CUDA unless ``--device cpu``; one device, no
mesh.  Before drawing any weight it checks that the training state fits
the card's free memory (:func:`check_fits`): the parameters and their
gradients in the model dtype plus AdamW's two fp32 moments, about 12
bytes a parameter in bf16.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.layers import model_dtype
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW, cosine_schedule


def train_state_bytes(cfg: ModelConfig) -> int:
    """Parameters and gradients in the model dtype and AdamW's fp32 m and
    v: ``param_count() * (2 * itemsize + 8)``."""
    return cfg.param_count() * (2 * model_dtype(cfg).itemsize + 8)


def check_fits(cfg: ModelConfig, device: torch.device) -> None:
    """Raise unless the config's training state fits the free memory of
    CUDA ``device``; no check on the CPU."""
    if device.type != "cuda":
        return
    need = train_state_bytes(cfg)
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
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduce_for_smoke(cfg)
    check_fits(cfg, dev)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=max(args.steps // 20, 1),
                                   total=args.steps))
    data = DataConfig(batch_size=args.batch, seq_len=args.seq)
    out = train(cfg, steps=args.steps, data=data, opt=opt,
                ckpt_path=args.ckpt, remat=args.remat, device=dev)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
