"""Percentiles, rates and spreads, as the benchmark reports them."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all ``values``, by linear
    interpolation between order statistics (numpy's default); an
    infinite value (a request that never came) ranks above all others."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """``count`` events over a window of ``seconds``: all of the window's
    work over all of its time."""
    if seconds <= 0:
        raise ValueError("a rate over an empty window")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles, as
    ``statistics.quantiles(values, n=4)`` gives them, as a share of the
    median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
