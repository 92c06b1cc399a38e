"""Whether the tokens the timed path served are the model's greedy tokens.

Once the window has closed and the program is freed, a sample of the
requests the engine finished, drawn from the seed with the longest
among them, goes to the plain reference of the configuration's family
(``bench/reference/<family>.py``), with weights drawn again from the
seed.  The reference runs once over each prompt and its served tokens
but the last, in float32, and gives the logits at every served
position.  The number compared is the widest gap by which a served
token's logit lies below the reference's best at its position: 0 where
every served token is the reference's argmax, small where bfloat16
rounding flipped a near tie.

The control puts the reference in the program's place at the nearest
precision below bfloat16 (``precision.fp8``): at each of the same
positions the token it puts first, and that token's gap in the float32
reference.  The benchmark's runs do not run it; ``bench/calibrate.py``
does, to set the limit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from bench.harness import spec
from bench.harness import weights as weights_mod
from bench.reference import precision


@dataclasses.dataclass
class Served:
    prompt: np.ndarray
    tokens: List[int]


@dataclasses.dataclass
class Result:
    requests: int
    tokens: int
    max_gap: float
    control_gap: Optional[float] = None


def sample(finished: List[Served], seed: int, tokens: int) -> List[Served]:
    """The longest-served request, then others in an order drawn from the
    seed until ``tokens`` served tokens are in the sample."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: (len(finished[i].tokens), -i))
    rest = [i for i in range(len(finished)) if i != longest]
    order = np.random.default_rng([seed % 2**63, 4]).permutation(len(rest))
    out = [finished[longest]]
    for j in order:
        if sum(len(s.tokens) for s in out) >= tokens:
            break
        out.append(finished[rest[j]])
    return out


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """ref: (n, V) float32 logits; tokens: (n,).  How far each token's
    logit lies below its row's best."""
    return ref.max(-1).values - ref.gather(-1, tokens[:, None])[:, 0]


def compare(cell: spec.Cell, seed: int, requests: List[Served], device,
            control: bool = False) -> Result:
    """Run the cell's reference (and, with ``control``, the fp8 control)
    over ``requests`` and return the widest gaps."""
    if not requests:
        return Result(0, 0, float("nan"))
    model, reference = cell.config["model"], cell.reference
    w = weights_mod.make(cell.family.leaves(model), seed, device)
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]),
                            dtype=torch.long, device=device)
            for r in requests]
    firsts = [len(r.prompt) - 1 for r in requests]
    served = torch.as_tensor(np.concatenate([r.tokens for r in requests]),
                             dtype=torch.long, device=device)
    with precision.no_tf32():
        ref = torch.cat(reference.forward(w, model, seqs, firsts,
                                       precision.exact))
        out = Result(len(requests), int(served.numel()),
                     float(gaps(ref, served).max()))
        if control:
            low = torch.cat(reference.forward(w, model, seqs, firsts,
                                           precision.fp8))
            out.control_gap = float(gaps(ref, low.argmax(-1)).max())
    return out
