"""The arithmetic of the end-to-end metrics and of the device's busy time.

Rates are whole-window rates (all the work completed in the window over the
window's seconds) and tails are over every request in the window; neither
comes from medians of chunks.
"""

from __future__ import annotations

import numpy as np


def rate(n_completed: int, seconds: float) -> float:
    """Work completed in the window over the window's length."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return n_completed / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (linear interpolation between the
    two nearest ranks); NaN for no values."""
    v = np.asarray(list(values), np.float64)
    if v.size == 0:
        return float("nan")
    return float(np.percentile(v, q))


def gaps(times) -> list:
    """The gaps between consecutive completion times (sorted)."""
    t = np.sort(np.asarray(list(times), np.float64))
    return list(np.diff(t))


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals, in seconds."""
    if not intervals:
        return 0.0
    arr = np.asarray(sorted(intervals), np.float64)
    s, e = arr[:, 0], np.maximum.accumulate(arr[:, 1])
    gap = np.maximum(s[1:] - e[:-1], 0.0)
    return float(e[-1] - s[0] - gap.sum())
