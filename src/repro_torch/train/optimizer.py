"""AdamW and LR schedules in plain PyTorch (port of ``repro.train.optimizer``).

The reference's semantics, leaf by leaf: the step counter increments
before use; gradients are clipped by their global norm (``+1e-9`` in the
denominator); ``m`` and ``v`` live in ``state_dtype`` (fp32) whatever the
parameter's dtype; the bias corrections take float32 powers; weight
decay applies to every leaf (norm scales, biases and the fp32 router
included); the update is computed in fp32, cast to the parameter's dtype
and only then added, so a bf16 parameter is rounded twice, as in the
reference.  ``torch.optim.AdamW`` keeps bf16 state for bf16 parameters
and rounds once, so it is not used.

Parameters, gradients and the moments are dicts of tensors keyed by
parameter name (``dict(module.named_parameters())``).  The moments are
updated in place (the reference returns new trees; here a second copy
of the fp32 state would not fit beside a large model), and
:meth:`AdamW.step_` applies each leaf's update as soon as it is
computed, so the fp32 temporaries are the size of one leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.dist.sharding import placed_like

Tensors = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 scalar
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    state_dtype: torch.dtype = torch.float32

    def init(self, params: Tensors) -> AdamWState:
        def zeros(p):       # placed like p where p is a DTensor
            return torch.zeros_like(p, dtype=self.state_dtype)
        dev = next(iter(params.values())).device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m={n: zeros(p) for n, p in params.items()},
                          v={n: zeros(p) for n, p in params.items()})

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        lr = self.lr(step) if callable(self.lr) else self.lr
        return torch.as_tensor(lr, dtype=torch.float32, device=step.device)

    def _prepare(self, grads: Tensors, state: AdamWState):
        """The new step, the clip scale (None without clipping), the bias
        corrections and the learning rate, as fp32 scalars."""
        step = state.step + 1
        scale = None
        if self.grad_clip is not None:
            gnorm = global_norm(grads)
            clip = torch.full_like(gnorm, self.grad_clip)
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
        f32 = torch.float32
        s = step.to(f32)
        bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=f32,
                                         device=s.device), s)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=f32,
                                         device=s.device), s)
        return step, scale, bc1, bc2, self._lr(step)

    def _leaf(self, p, g, m, v, scale, bc1, bc2, lr) -> torch.Tensor:
        """Updates the moments m, v in place; returns the leaf's update in
        p's dtype.  Each op rounds as the reference's does (products and
        sums apart, in its order); in-place ops on this leaf's own fp32
        copies keep the temporaries to a few of its size."""
        g = g.to(self.state_dtype, copy=True)
        if scale is not None:
            g.mul_(scale)
        m.mul_(self.b1).add_(g * (1 - self.b1))
        v.mul_(self.b2).add_(g.square_().mul_(1 - self.b2))
        del g
        u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
        u.add_(p.to(self.state_dtype) * self.weight_decay)
        return u.mul_(-lr).to(p.dtype)

    def update(self, grads: Tensors, state: AdamWState, params: Tensors
               ) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
        """The reference's ``update``: (updates in each parameter's dtype,
        the new state).  The moments of ``state`` are updated in place."""
        grads = {n: placed_like(params[n], grads[n]) for n in params}
        step, *consts = self._prepare(grads, state)
        updates = {n: self._leaf(params[n], grads[n], state.m[n],
                                 state.v[n], *consts) for n in params}
        return updates, AdamWState(step=step, m=state.m, v=state.v)

    @torch.no_grad()
    def step_(self, params: Tensors, grads: Tensors,
              state: AdamWState) -> AdamWState:
        """``update`` and ``apply_updates`` at once, leaf by leaf, in place:
        each parameter gets its update before the next leaf's is made."""
        grads = {n: placed_like(params[n], grads[n]) for n in params}
        step, *consts = self._prepare(grads, state)
        for n, p in params.items():
            p.add_(self._leaf(p, grads[n], state.m[n], state.v[n], *consts))
        return AdamWState(step=step, m=state.m, v=state.v)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """p <- p + u in p's dtype, in place (the reference returns new
    parameters)."""
    for n, p in params.items():
        p.add_(updates[n])


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, fp32."""
    total = None
    for leaf in tree.values():
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; a function of the (int)
    step tensor returning an fp32 scalar tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)
    return lr
