"""Percentiles, rates and the window's arithmetic on known samples."""
import math
import statistics

import pytest

from bench.harness import serve, stats


def test_percentile_is_over_all_samples():
    xs = list(range(1, 101))              # 1..100
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    # the tail of all samples, not of a subset: one slow sample of 20 moves it
    assert stats.percentile([1.0] * 19 + [100.0], 95) == pytest.approx(5.95)


def test_percentile_ranks_a_missing_request_last():
    assert stats.percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert stats.percentile([1.0, 2.0, math.inf], 95) == math.inf
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate_is_over_the_whole_window():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_matches_statistics_quantiles():
    xs = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))


def _tracked(kind, due, times, admit=math.nan):
    tr = serve.Tracked(req=None, kind=kind, due=due, submitted=due,
                       times=times)
    tr.admit_start = admit
    return tr


def test_window_tokens_gaps_and_ttft():
    a = _tracked("niw", 0.0, [0.5, 1.5, 2.5, 3.5], admit=0.1)
    b = _tracked("iw", 1.2, [2.0, 2.0, 3.0], admit=1.6)
    c = _tracked("iw", 2.9, [], admit=math.nan)
    w = serve.Window(t0=1.0, t_end=3.2, seconds=2.2, steps=[],
                     requests=[a, b, c], iw=[b, c], generator_late_s=0.0,
                     drain_end=10.0)
    # tokens visible in (1.0, 3.2]: a's 1.5, 2.5; b's 2.0, 2.0, 3.0
    assert w.tokens() == 5
    # gaps whose later token is in the window: a 1.0, 1.0; b 0.0, 1.0
    assert sorted(w.gaps()) == [0.0, 1.0, 1.0, 1.0]
    assert w.ttft(b) == pytest.approx(0.8)
    assert w.ttft(c) == pytest.approx(10.0 - 2.9)   # never served: the wait
    assert w.missing() == 1
    assert w.attempted() == 2                        # b and c are due inside
