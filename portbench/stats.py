"""Tail statistics over every sample, misses included."""

from __future__ import annotations

import math
from typing import Iterable, Optional

MISS = math.inf


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (the smallest value that at
    least ``q`` percent of the samples do not exceed). A miss enters as
    ``MISS`` (+inf) and sorts last, so a tail that lands on one reads
    +inf. ``None`` for no samples."""
    ordered = sorted(values)
    if not ordered:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]
