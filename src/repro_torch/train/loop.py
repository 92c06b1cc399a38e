"""Training loop: train-step factory and driver with checkpointing (port of ``repro.train.loop``).

``make_train_step`` returns a function that takes one optimizer step in
place: the loss (``model.loss_fn``) and its gradients by autograd,
through the kernels K2 and K3 and their backward kernels on the card
(``kernels.ops``), then AdamW leaf by leaf (``AdamW.step_``).  Every
parameter must receive a gradient: one left with ``grad`` None raises.
``train`` draws the model from a seeded generator on ``device`` (CUDA
unless asked otherwise), trains it on ``SyntheticLM`` batches, logs and
checkpoints as the reference does, and returns the same dict.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as model_mod
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.optimizer import AdamW, AdamWState, global_norm


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A ``SyntheticLM`` batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt: AdamW,
                    remat: bool = False) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    ``params`` (the model, its parameters requiring grad) is updated in
    place; metrics hold the loss and the gradients' global norm before
    clipping, as 0-d tensors."""
    def step_fn(params: nn.Module, opt_state: AdamWState, batch: Dict):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        loss = model_mod.loss_fn(cfg, params, batch, remat=remat)
        loss.backward()
        missing = [n for n, p in named.items() if p.grad is None]
        if missing:
            raise RuntimeError(f"{cfg.name}: no gradient reached "
                               f"{len(missing)} parameters: {missing[:4]}")
        grads = {n: p.grad for n, p in named.items()}
        with torch.no_grad():
            gnorm = global_norm(grads)
        opt_state = opt.step_(named, grads, opt_state)
        for p in named.values():
            p.grad = None
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step_fn


def train(cfg: ModelConfig, steps: int = 100,
          data: Optional[DataConfig] = None, opt: Optional[AdamW] = None,
          seed: int = 0, ckpt_path: Optional[str] = None,
          ckpt_every: int = 0, log_every: int = 10, remat: bool = False,
          verbose: bool = True, device: DeviceLike = None) -> Dict[str, Any]:
    """Returns {"params", "opt_state", "losses"}: the trained model, the
    optimizer state and the (step, loss) pairs logged."""
    dev = resolve_device(device)
    data = data or DataConfig()
    opt = opt or AdamW()
    params = model_mod.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
    params.requires_grad_(True)
    opt_state = opt.init(dict(params.named_parameters()))
    step_fn = make_train_step(cfg, opt, remat=remat)
    ds = SyntheticLM(cfg, data)

    losses = []
    t0 = time.time()
    for i, batch in enumerate(ds.batches(steps)):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             batch_to(batch, dev))
        if i % log_every == 0 or i == steps - 1:
            lv = float(metrics["loss"])
            losses.append((i, lv))
            if verbose:
                print(f"step {i:5d}  loss {lv:.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"{(time.time()-t0):.1f}s", flush=True)
        if ckpt_path and ckpt_every and i and i % ckpt_every == 0:
            ckpt_mod.save(ckpt_path, params, step=i)
    if ckpt_path:
        ckpt_mod.save(ckpt_path, params, step=steps)
    return {"params": params, "opt_state": opt_state, "losses": losses}
