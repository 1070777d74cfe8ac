"""Arithmetic of the end-to-end metrics and of the spreads that set their
bounds."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The *q*-th percentile (0 < q < 100) by the nearest rank: the
    smallest value that at least q % of *values* do not exceed."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError('percentile of no values')
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f'window of {seconds} s')
    return work / seconds


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile, as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
