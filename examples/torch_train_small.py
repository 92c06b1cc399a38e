"""Train a ~100M-param model for a few hundred steps on synthetic data, on the PyTorch port.

Counterpart of ``examples/train_small.py`` on ``repro_torch``: the full
training substrate (AdamW, cosine schedule, npz checkpointing, the
model's forward and backward through the port's kernels on CUDA) at a
small size.  ``--layers`` and ``--d-model`` shrink the model (heads stay
8, the feed-forward width 4 d_model).  The checkpoint goes to
``build/torch_train_small.npz`` in the checkout unless ``--ckpt`` says
otherwise.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW, cosine_schedule


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt",
                    default=os.path.join(ROOT, "build",
                                         "torch_train_small.npz"))
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M-param gemma-family config (8 layers, d=768) by default
    cfg = dataclasses.replace(
        get_arch("gemma-7b"), name="gemma-100m", num_layers=args.layers,
        d_model=args.d_model, num_heads=8, num_kv_heads=8,
        head_dim=args.d_model // 8, d_ff=4 * args.d_model,
        vocab_size=32_000)
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.0f}M  "
          f"on {dev}")
    os.makedirs(os.path.dirname(os.path.abspath(args.ckpt)), exist_ok=True)
    out = train(cfg, steps=args.steps,
                data=DataConfig(batch_size=8, seq_len=128),
                opt=AdamW(lr=cosine_schedule(3e-4, warmup=20,
                                             total=args.steps)),
                ckpt_path=args.ckpt, ckpt_every=100, log_every=20,
                device=dev)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f}; checkpoint at {args.ckpt}")
    if not last < first:
        raise RuntimeError(f"the loss did not fall: {first} -> {last}")


if __name__ == "__main__":
    main()
