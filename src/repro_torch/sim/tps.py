"""Rolling-window TPS bookkeeping for the simulator hot path.

``TpsHistory`` replaces the unbounded per-(model, region) bucket dicts
the simulator used to rebuild on every tick (``observed_tps``) and every
hour (``history_series`` — O(T²) over a run of T buckets).  Buckets live
in per-key ring buffers sized to the maximum lookback, so

- ``note`` is O(1) (arrivals are time-ordered, so the ring only ever
  rolls forward),
- window sums are O(window buckets), independent of run length,
- memory is O(keys × lookback), independent of run length.

Summation runs over the same bucket order as the old dict-based code, so
results are bit-identical for runs shorter than the lookback.
"""
from __future__ import annotations

import math
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np


class TpsHistory:
    """Per-key bucketed counters over a bounded trailing window."""

    def __init__(self, keys: Sequence[Hashable], window: float,
                 lookback: float):
        if window <= 0:
            raise ValueError("window must be positive")
        self.window = float(window)
        self.keys: List[Hashable] = list(keys)
        self.capacity = max(int(math.ceil(lookback / window)), 2)
        # per-key Python lists: scalar += on a list is ~5x cheaper than
        # numpy fancy indexing, and note() runs once per arrival
        self._buf: Dict[Hashable, List[float]] = {
            k: [0.0] * self.capacity for k in self.keys}
        self._hi = 0          # highest absolute bucket index materialized

    # ------------------------------------------------------------------ note
    def note(self, key: Hashable, t: float, value: float) -> None:
        b = int(t / self.window)
        if b > self._hi:
            self._roll_to(b)
        elif b <= self._hi - self.capacity:
            return  # older than the ring (cannot happen for ordered input)
        self._buf[key][b % self.capacity] += value

    def _roll_to(self, b: int) -> None:
        """Zero the ring slots being re-entered for buckets (_hi, b]."""
        gap = b - self._hi
        cap = self.capacity
        if gap >= cap:
            for buf in self._buf.values():
                for i in range(cap):
                    buf[i] = 0.0
        else:
            lo = (self._hi + 1) % cap
            for buf in self._buf.values():
                for off in range(gap):
                    buf[(lo + off) % cap] = 0.0
        self._hi = b

    # --------------------------------------------------------------- queries
    def _bucket_range(self, b_lo: int, b_hi: int) -> range:
        """Valid absolute buckets in [b_lo, b_hi], clamped to the ring."""
        lo = max(b_lo, 0, self._hi - self.capacity + 1)
        return range(lo, b_hi + 1)

    def window_mean(self, now: float, horizon: float,
                    include_current: bool = True) -> Dict[Hashable, float]:
        """Mean bucket value over the trailing ``horizon`` seconds.

        ``include_current=True`` averages buckets (b-n, b] (the old
        ``observed_tps`` convention); ``False`` averages [b-n, b) (the
        old ``niw_last_hour`` convention).
        """
        b = int(now / self.window)
        if b > self._hi:
            self._roll_to(b)
        nb = max(int(horizon / self.window), 1)
        if include_current:
            rng = self._bucket_range(b - nb + 1, b)
        else:
            rng = self._bucket_range(b - nb, b - 1)
        cap = self.capacity
        out = {}
        if not len(rng):
            return {key: 0.0 for key in self._buf}
        # contiguous ring segments: summed as C-level list slices, in the
        # same ascending-bucket order as the old dict-based accounting
        lo_p = rng[0] % cap
        n = len(rng)
        if lo_p + n <= cap:
            for key, buf in self._buf.items():
                out[key] = sum(buf[lo_p:lo_p + n]) / nb
        else:
            head = cap - lo_p
            for key, buf in self._buf.items():
                # sum(seq, start) keeps strict left-to-right accumulation
                # across the wrap (bit-identical to one sequential pass)
                out[key] = sum(buf[:n - head], sum(buf[lo_p:])) / nb
        return out

    def series(self, now: float) -> Dict[Hashable, np.ndarray]:
        """Per-key bucket series for buckets [0, b_now), clipped to the
        trailing ``capacity`` buckets — what the hourly forecaster fits
        on.  O(lookback), not O(run length)."""
        b = int(now / self.window)
        if b > self._hi:
            self._roll_to(b)
        rng = self._bucket_range(max(0, b - self.capacity), b - 1)
        cap = self.capacity
        out = {}
        for key, buf in self._buf.items():
            out[key] = np.array([buf[i % cap] for i in rng])
        return out

    def memory_buckets(self) -> int:
        """Total buckets held — constant for the life of the history."""
        return sum(len(b) for b in self._buf.values())
