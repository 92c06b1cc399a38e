"""Continuous-batching serving engine on real models (port of ``repro.serving.engine``).

Fixed decode slots over a preallocated KV cache, policy-ordered
admission through the shared scheduler registry (FCFS/EDF/PF/DPA/WSL or
a custom ordering callable), prefill-then-decode with greedy sampling.
Admission, slot and step semantics are the reference's: every step
decodes all ``max_batch`` slots (idle ones with token 0 at position 0),
a request stops after ``max_new_tokens`` or at ``pos >= max_seq - 1``,
and a prefill overwrites only the first S positions of its slot's
attention cache (stale positions beyond S stay and are masked by
``kp <= cur``) but the whole of its SSM state and conv window, which
idle decode steps keep advancing, and of its cross-attention cache,
which decode only reads.  A VLM prompt follows min(num_patches, 4)
zero patch embeddings, and its decode positions start after them; an
audio prompt is decoded against encoder_seq zero frames (the stubbed
front ends of the reference's engine).  The engine
runs on CUDA unless the caller passes ``device="cpu"``; the cache is
updated in place.  Every step runs under ``torch.inference_mode()``.

The engine times itself (``repro_torch.tracing``), always on:
``serve.submit`` (zero length, per request), ``serve.step`` (``n``:
slots active at decode) holding ``serve.admit`` (``n``: queue length;
the policy's order and the prefills) and ``serve.decode`` (``n``: active
slots).  Each ``serve.prefill`` (``rid``, ``n`` = S) holds
``serve.first_token`` (argmax and its copy to the host: the host waits
for the device) and ``serve.write_slot`` (asynchronous); the decode
holds ``serve.sample`` (argmax and ``.cpu()``: the host waits).  A
request's ``ttft_s`` runs from its submit to the return of the step that
made its first token.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device, tracing
from repro_torch.api.registry import resolve
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.models.layers import model_dtype


@dataclasses.dataclass
class ServeRequest:
    """RequestLike over a real token prompt: prompt/output token counts
    derive from the prompt array and decode budget unless set."""

    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int
    model: str = ""
    region: str = "local"
    tier: str = "IW-N"
    arrival: float = 0.0
    ttft_deadline: float = math.inf
    priority: int = 1
    prompt_tokens: int = 0           # 0 → len(prompt)
    output_tokens: int = 0           # 0 → max_new_tokens
    # outputs
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_step: Optional[int] = None
    done_step: Optional[int] = None
    submit_ns: Optional[int] = None  # tracing clock (perf_counter_ns)
    ttft_s: Optional[float] = None   # submit to its first token's step end

    def __post_init__(self):
        if not self.prompt_tokens:
            self.prompt_tokens = len(self.prompt)
        if not self.output_tokens:
            self.output_tokens = self.max_new_tokens

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.output_tokens

    @property
    def deadline(self):
        return self.ttft_deadline


@dataclasses.dataclass
class _Slot:
    req: Optional[ServeRequest] = None
    pos: int = 0                      # next position to write
    remaining: int = 0


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_seq: int = 512,
                 scheduler: Union[str, Callable] = "fcfs",
                 device: DeviceLike = None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.order_fn = resolve("scheduler", scheduler)
        self.device = resolve_device(device)
        self.queue: List[ServeRequest] = []
        self.slots = [_Slot() for _ in range(max_batch)]
        self.cache = model_mod.init_decode_cache(cfg, max_batch, max_seq,
                                                 device=self.device)
        self.step_count = 0
        self._first: List[ServeRequest] = []   # admitted this step
        self._prefill = functools.partial(model_mod.forward, cfg,
                                          return_cache=True)
        self._decode = functools.partial(model_mod.decode_step, cfg)

    # ---------------------------------------------------------------- intake
    def submit(self, req: ServeRequest) -> None:
        req.submit_ns = tracing.mark("serve.submit", self.step_count,
                                     req.rid)
        self.queue.append(req)

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.active > 0

    # ----------------------------------------------------------------- steps
    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s.req is None]
        if not free or not self.queue:
            return
        self.queue = self.order_fn(self.queue, float(self.step_count))
        while free and self.queue:
            req = self.queue.pop(0)
            slot = free.pop(0)
            self._prefill_into(slot, req)

    def _prefill_into(self, slot: int, req: ServeRequest) -> None:
        S = len(req.prompt)
        step = self.step_count
        with tracing.span("serve.prefill", step, req.rid, S):
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None, :]
            batch, offset = prefill_batch(self.cfg, tokens)
            if S + offset > self.max_seq:
                raise ValueError(f"request {req.rid}: prompt of {S} tokens "
                                 f"(after {offset} patches) does not fit "
                                 f"max_seq={self.max_seq}")
            logits, pcache, _ = self._prefill(self.params, batch)
            with tracing.span("serve.first_token", step, req.rid):
                next_tok = int(torch.argmax(logits[0, -1]))
            with tracing.span("serve.write_slot", step, req.rid):
                _write_slot(self.cache, pcache, slot)
        st = self.slots[slot]
        st.req = req
        st.pos = S + offset
        st.remaining = req.max_new_tokens - 1
        req.tokens.append(next_tok)
        req.ttft_step = step
        self._first.append(req)
        if st.remaining <= 0:
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        st = self.slots[slot]
        st.req.done_step = self.step_count
        st.req = None
        st.pos = 0
        st.remaining = 0

    @torch.inference_mode()
    def step(self) -> None:
        """One engine iteration: admit waiting requests, decode one token
        for every active slot.  Runs under ``torch.inference_mode()``: no
        graph is built, whether or not the parameters require grad."""
        self.step_count += 1
        with tracing.span("serve.step", self.step_count) as sp:
            self._step(sp)
        for req in self._first:
            if req.submit_ns is not None:
                req.ttft_s = (sp.t1 - req.submit_ns) / 1e9
        self._first.clear()

    def _step(self, sp: tracing.span) -> None:
        step = self.step_count
        with tracing.span("serve.admit", step, n=len(self.queue)):
            self._admit()
        if self.active == 0:
            return
        sp.n = self.active
        with tracing.span("serve.decode", step, n=sp.n):
            toks = np.zeros((self.max_batch, 1), np.int64)
            pos = np.zeros((self.max_batch,), np.int32)
            for i, s in enumerate(self.slots):
                if s.req is not None:
                    toks[i, 0] = s.req.tokens[-1]
                    pos[i] = s.pos
            logits, self.cache = self._decode(
                self.params, torch.from_numpy(toks).to(self.device),
                self.cache, torch.from_numpy(pos).to(self.device))
            with tracing.span("serve.sample", step):
                nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            s.req.tokens.append(int(nxt[i]))
            s.pos += 1
            s.remaining -= 1
            if s.remaining <= 0 or s.pos >= self.max_seq - 1:
                self._finish(i)

    def run(self, max_steps: int = 10_000) -> None:
        while self.has_work and self.step_count < max_steps:
            self.step()


def prefill_batch(cfg: ModelConfig, tokens: torch.Tensor):
    """The engine's model inputs for prompts ``tokens`` (B, S): with them
    an audio model's encoder_seq zero frames, a VLM's min(num_patches, 4)
    zero patch embeddings ahead of the prompt (the stubbed front ends).
    Returns (batch, offset): the prompt's first position is ``offset``."""
    B, dev, dt = tokens.shape[0], tokens.device, model_dtype(cfg)
    batch = {"tokens": tokens}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                      dtype=dt, device=dev)
    if cfg.family != "vlm":
        return batch, 0
    offset = min(cfg.num_patches, 4)
    batch["patches"] = torch.zeros((B, offset, cfg.d_model), dtype=dt,
                                   device=dev)
    return batch, offset


@torch.no_grad()
def _write_slot(cache: Dict, prefill_cache: Dict, slot: int) -> Dict:
    """Write a single-request prefill cache into decode-cache slot `slot`.

    Decode leaves are stacked (L, B, W, ...); prefill leaves are
    (L, 1, S, ...): write at [:, slot, :S] in place, leaving slots
    beyond S as they were, whatever the leaf's name (K/V, MLA's latent
    and rope keys, positions).  SSM states (L, 1, H, P, N), conv windows
    (L, 1, 3, C) and an encoder-decoder's cross cache
    (L, 1, encoder_seq, Hkv, hd) span their whole axis 2, so they are
    replaced whole.
    """
    for family, leaves in prefill_cache.items():
        for name, src in leaves.items():
            dst = cache[family][name]
            dst[:, slot, :src.shape[2]] = src[:, 0].to(dst.dtype)
    return cache
