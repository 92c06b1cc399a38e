"""The placed MoE dispatch's ranking, with no process group.

Placed, each device ranks only its own tokens' (token, expert) pairs: a
pair's global position is the count of its expert's pairs on the
earlier pieces of the token split plus its stable rank within its own
piece (``models.moe.piece_ranks``, fed by each piece's per-expert counts
as ``dist.sharding.row_pieces`` all-gathers them).  For seeded random
expert ids cut into R contiguous pieces at random points (empty pieces
included), the pieces' positions, ``keep`` and ``dest`` equal the
unsplit ranking's exactly: ``models.moe.group_ranks`` on all the pairs,
and a numpy stable argsort, the reference's rule.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.models import moe

torch.set_num_threads(1)

#: (pieces R, tokens T, top-k K, experts E, capacity factor): the reduced
#: configs' widths on the test meshes, uneven and empty pieces, DeepSeek-V3's
#: and Llama-4 Scout's routing widths, and capacities that drop nothing,
#: some or most pairs
CASES = [(1, 7, 1, 4, 1.25), (2, 64, 2, 4, 1.25), (2, 64, 1, 4, 0.5),
         (3, 50, 2, 8, 1.25), (4, 128, 8, 16, 1.0), (5, 33, 3, 7, 2.0),
         (8, 512, 8, 256, 1.25), (16, 1000, 1, 16, 1.25),
         (16, 40, 2, 4, 0.25), (7, 1, 1, 3, 1.25)]


def _unsplit(e: np.ndarray, E: int):
    """The reference's ranking of the token-major flat ids ``e``: a stable
    argsort, each pair's rank within its expert's group."""
    order = np.argsort(e, kind="stable")
    counts = np.bincount(e, minlength=E)
    start = np.cumsum(counts) - counts
    pos = np.empty_like(e)
    pos[order] = np.arange(e.size) - start[e[order]]
    return pos


def _cuts(rng, T: int, R: int):
    """R contiguous pieces of T tokens, cut at random points."""
    return np.concatenate([[0], np.sort(rng.integers(0, T + 1, R - 1)), [T]])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("R,T,K,E,cf", CASES)
def test_piece_ranks_equal_the_global_ranking(R, T, K, E, cf, seed):
    rng = np.random.default_rng([seed, R, T, K, E])
    eidx = rng.integers(0, E, (T, K))
    # a skewed router too: most pairs on a few experts
    if seed == 2:
        eidx = np.minimum(rng.geometric(0.4, (T, K)) - 1, E - 1)
    C = max(1, math.ceil(T * K / E * cf))
    e = torch.from_numpy(eidx.reshape(-1))
    pos = moe.group_ranks(e, moe.expert_counts(e, E))
    assert np.array_equal(pos.numpy(), _unsplit(eidx.reshape(-1), E))

    cuts = _cuts(rng, T, R)
    pieces = [torch.from_numpy(eidx[a:b].reshape(-1))
              for a, b in zip(cuts[:-1], cuts[1:])]
    every = torch.stack([moe.expert_counts(p, E) for p in pieces])
    assert torch.equal(every.sum(0), moe.expert_counts(e, E))
    got = torch.cat([moe.piece_ranks(p, every, r)
                     for r, p in enumerate(pieces)])
    assert torch.equal(got, pos)
    keep, got_keep = pos < C, got < C
    assert torch.equal(got_keep, keep)
    dest = torch.where(keep, e * C + pos, E * C)
    assert torch.equal(torch.where(got_keep, e * C + got, E * C), dest)
    # the dispatch counts dropped pairs from the whole step's counts
    assert int((every.sum(0) - C).clamp_min(0).sum()) == \
        T * K - int(keep.sum())
