"""The window's arithmetic: a rate over all the work and all the time of the
window, and a tail over every request in it. Pure functions of host-clock
readings, so that the tests can feed them an injected stall."""
from __future__ import annotations

import math
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """Work completed per second of the window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest value with at
    least a fraction q of the values at or below it (a value that occurred)."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(math.ceil(q * len(v)), 1) - 1]

