"""The traffic generator: seeded, within its ranges, the same work for
every seed."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from bench.harness import traffic

MIXES = sorted(
    (Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))


def _mix(path):
    return json.loads(path.read_text())


def _draws(mix, seed, n, stream=0, tiers=None):
    s = traffic.Stream(mix, seed, 1000, stream,
                       tiers or ["NIW"] * traffic.BLOCK)
    return [s.next() for _ in range(n)]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    mix = _mix(path)
    a = _draws(mix, 2**31 + 5, 100)
    b = _draws(mix, 2**31 + 5, 100)
    assert [(d.max_new_tokens, d.tier) for d in a] == \
        [(d.max_new_tokens, d.tier) for d in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = _draws(mix, 7, 100)
    assert [len(d.prompt) for d in a] != [len(d.prompt) for d in c]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_lengths_within_ranges_and_context(path):
    mix = _mix(path)
    traffic.check_mix(mix, 4096)
    for d in _draws(mix, 3, 3 * traffic.BLOCK):
        assert mix["prompt"]["min"] <= len(d.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= d.max_new_tokens <= mix["output"]["max"]
        assert len(d.prompt) + d.max_new_tokens <= 4095
        assert d.prompt.min() >= 0 and d.prompt.max() < 1000


def test_check_mix_refuses_overlong():
    mix = {"prompt": {"max": 4000}, "output": {"max": 200}}
    with pytest.raises(ValueError):
        traffic.check_mix(mix, 4096)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_seed_the_same_sizes_per_block(path):
    mix = _mix(path)
    n = 2 * traffic.BLOCK
    for stream_seeds in ((1, 99), (5, 2**31 + 1)):
        sizes = [Counter((len(d.prompt) for d in _draws(mix, s, n)))
                 for s in stream_seeds]
        assert sizes[0] == sizes[1]


def test_lengths_follow_the_truncated_lognormal():
    """Drawn as if redrawn until in range: the median is the truncated
    distribution's, here below 2,048 since the upper cut is the nearer."""
    from scipy.special import ndtr, ndtri
    spec = {"median": 2048, "sigma": 0.5, "min": 256, "max": 3968}
    x = traffic.length_block(spec, 4096)
    lo = ndtr(np.log(256 / 2048) / 0.5)
    hi = ndtr(np.log(3968.5 / 2048) / 0.5)
    median = 2048 * np.exp(0.5 * ndtri((lo + hi) / 2))
    assert abs(np.median(x) - median) < 2
    assert x.min() >= 256 and x.max() <= 3968


def test_arrivals_keep_the_rate_for_every_seed():
    for seed in (1, 2, 2**31 + 3):
        a = traffic.Arrivals(8.0, seed)
        due = [a.next() for _ in range(traffic.BLOCK)]
        assert due == sorted(due)
        # a whole block of gaps is the same set: the same span
        assert due[-1] == pytest.approx(traffic.gap_block(8.0).sum())
    assert traffic.gap_block(8.0).mean() == pytest.approx(1 / 8.0, rel=0.1)


def test_iw_tiers_share():
    tiers = traffic.iw_tiers({"iw": {"iwf_share": 0.65}})
    assert len(tiers) == traffic.BLOCK
    assert tiers.count("IW-F") == 42
