"""Synthetic LM data pipeline: deterministic, shardable token streams.

For the end-to-end training example we synthesize a Zipf-distributed token
stream with local n-gram structure (so the loss actually decreases) and
yield model-ready batches for any architecture (tokens / frames+tokens /
patches+tokens).  Batches are generated on host with numpy and can be
device_put with a NamedSharding for multi-host runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Markov-ish synthetic tokens: next token depends on previous token
    half the time (learnable structure), Zipf-marginal otherwise."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self.rng = np.random.default_rng(data.seed)
        v = cfg.vocab_size
        # fixed random successor table
        self.succ = np.random.default_rng(data.seed + 1).integers(
            0, v, size=(v,), dtype=np.int32)

    def _tokens(self, n: int) -> np.ndarray:
        v = self.cfg.vocab_size
        z = self.rng.zipf(self.data.zipf_a, size=n).astype(np.int64)
        base = (z - 1) % v
        out = np.empty(n, np.int32)
        out[0] = base[0]
        use_succ = self.rng.random(n) < 0.5
        for i in range(1, n):
            out[i] = self.succ[out[i - 1]] if use_succ[i] else base[i]
        return out

    def batches(self, steps: Optional[int] = None) -> Iterator[Dict]:
        b, s = self.data.batch_size, self.data.seq_len
        i = 0
        while steps is None or i < steps:
            toks = self._tokens(b * s).reshape(b, s)
            batch = {"tokens": toks}
            if self.cfg.family == "audio":
                batch["frames"] = self.rng.normal(
                    0, 0.02, (b, self.cfg.encoder_seq, self.cfg.d_model)
                ).astype(np.float32)
            elif self.cfg.family == "vlm":
                pn = min(self.cfg.num_patches, max(1, s // 4))
                batch["patches"] = self.rng.normal(
                    0, 0.02, (b, pn, self.cfg.d_model)).astype(np.float32)
            yield batch
            i += 1
