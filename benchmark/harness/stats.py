"""Order statistics of host-clock samples."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile (0 < p <= 100): the smallest value
    with at least p% of the samples at or below it. A failed request enters
    as ``math.inf``, so it counts as missing any limit."""
    if len(values) == 0:
        raise ValueError("no samples")
    xs = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[k - 1]
