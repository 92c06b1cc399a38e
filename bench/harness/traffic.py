"""One generator for every traffic mix: a mix is a JSON file of parameters.

A mix (``bench/traffic/<name>.json``) gives the lengths of prompts and
outputs as truncated lognormals (``median``, ``sigma``, ``min``,
``max``), the engine's ``slots``, an optional open-loop interactive
stream (``iw``: ``rate_per_s``, ``iwf_share``, ``deadline_steps``) and a
closed-loop batch backlog (``niw``: ``depth``).

Every seed gets the same set of sizes and the same set of gaps between
arrivals, in another order: lengths and gaps are drawn as the quantiles
of their distributions at stratified points, in blocks of ``BLOCK``
draws, and the seed shuffles each block.  So any run that consumes a few
blocks has done the same work, whatever the seed, and runs of different
seeds differ by order alone.  Prompt token ids are uniform over the
vocabulary, drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List

import numpy as np
from scipy.special import ndtr, ndtri

#: draws per block: each block holds one stratified sample of the mix
BLOCK = 64


@dataclasses.dataclass
class Draw:
    """One request's sizes and, for the interactive stream, its tier."""

    prompt: np.ndarray        # (S,) int64 token ids
    max_new_tokens: int
    tier: str = "NIW"


def length_block(spec: Dict, n: int = BLOCK) -> np.ndarray:
    """``n`` lengths at the stratified quantiles (i + 0.5) / n of the
    lognormal with ``spec``'s median and sigma, truncated to [min, max]
    (so no mass piles up at the ends), rounded to whole tokens."""
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    lo = ndtr((math.log(spec["min"]) - mu) / sigma)
    hi = ndtr((math.log(spec["max"] + 0.5) - mu) / sigma)
    p = lo + (np.arange(n) + 0.5) / n * (hi - lo)
    x = np.exp(mu + sigma * ndtri(p))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def gap_block(rate: float, n: int = BLOCK) -> np.ndarray:
    """``n`` gaps between Poisson arrivals at ``rate`` per second: the
    exponential's quantiles at the stratified points (i + 0.5) / n."""
    return -np.log(1 - (np.arange(n) + 0.5) / n) / rate


def check_mix(mix: Dict, max_seq: int) -> None:
    """Raise if a prompt and its output can exceed ``max_seq - 1``
    positions (the engine stops a request at ``pos >= max_seq - 1``)."""
    most = mix["prompt"]["max"] + mix["output"]["max"]
    if most > max_seq - 1:
        raise ValueError(f"prompt max + output max = {most} exceeds "
                         f"max_seq - 1 = {max_seq - 1}")


class Stream:
    """An endless, seeded stream of requests of one kind of a mix.

    ``tiers`` is a block's tier for each draw (all "NIW" for the batch
    backlog); each block shuffles prompt lengths, output lengths and
    tiers apart, so the pairing differs by seed while the sets do not.
    """

    def __init__(self, mix: Dict, seed: int, vocab: int, stream: int,
                 tiers: List[str]):
        self.rng = np.random.default_rng([seed % 2**63, stream])
        self.prompts = length_block(mix["prompt"])
        self.outputs = length_block(mix["output"])
        self.tiers = np.array(tiers)
        self.vocab = vocab
        self._it = self._draws()

    def _draws(self) -> Iterator[Draw]:
        while True:
            p = self.rng.permutation(self.prompts)
            o = self.rng.permutation(self.outputs)
            t = self.rng.permutation(self.tiers)
            for i in range(BLOCK):
                toks = self.rng.integers(0, self.vocab, int(p[i]),
                                         dtype=np.int64)
                yield Draw(toks, int(o[i]), str(t[i]))

    def next(self) -> Draw:
        return next(self._it)


class Arrivals:
    """Due times (seconds after the stream's start) of the open-loop
    interactive stream: the same gaps for every seed, shuffled by it."""

    def __init__(self, rate: float, seed: int):
        self.rng = np.random.default_rng([seed % 2**63, 2])
        self.gaps = gap_block(rate)
        self.t = 0.0
        self._block: List[float] = []

    def next(self) -> float:
        if not self._block:
            self._block = list(self.rng.permutation(self.gaps))
        self.t += self._block.pop()
        return self.t


def iw_tiers(mix: Dict) -> List[str]:
    """A block's tiers: round(iwf_share * BLOCK) IW-F, the rest IW-N."""
    n_f = int(round(mix["iw"]["iwf_share"] * BLOCK))
    return ["IW-F"] * n_f + ["IW-N"] * (BLOCK - n_f)
