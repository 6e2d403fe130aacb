"""Percentile and rate arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (the smallest value with at least
    q% of the values at or below it); ``math.inf`` stands for a missing
    value, above every measured one. None for no values."""
    v = sorted(values)
    if not v:
        return None
    k = max(0, math.ceil(q / 100.0 * len(v)) - 1)
    return v[k]


def in_window(times: Iterable[float], t0: float, t1: float) -> List[float]:
    return [t for t in times if t0 <= t < t1]


def rate(count: float, t0: float, t1: float) -> float:
    """count over the window's seconds."""
    return count / (t1 - t0)


def gaps(times: Sequence[float]) -> List[float]:
    """Intervals between consecutive times."""
    return [b - a for a, b in zip(times, times[1:])]


def window_arrivals(chunk_times: Sequence[float], k: int) -> List[float]:
    """When each window's audio had arrived, from one request's chunk
    arrivals in order: a window delivers K chunks together (the last
    window of a request may deliver fewer), and has arrived with its last."""
    n = len(chunk_times)
    return [chunk_times[min(i + k, n) - 1] for i in range(0, n, k)]
