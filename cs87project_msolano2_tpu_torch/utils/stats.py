"""Shared order statistics: the nearest-rank percentile (the reference's
``utils/stats.py``).

One estimator for every latency table of the port (the serve SLO rows
and their live window), so a p99 means one thing everywhere: the value
at rank ceil(q/100 * N) of the sorted population (1-based), numpy's
``method="inverted_cdf"``.  No interpolation: a reported p99 is always a
latency that actually happened.
"""

from __future__ import annotations

__all__ = ["percentile_nearest_rank", "percentile_or_none"]


def percentile_nearest_rank(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) of a non-empty
    sequence.  Raises ``ValueError`` on an empty population or an
    out-of-range ``q``: an SLO over nothing is a bug at the caller,
    never a silent 0."""
    if not values:
        raise ValueError("percentile of an empty population")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    ordered = sorted(values)
    rank = max(1, -(-len(ordered) * q // 100))  # ceil without floats
    return ordered[int(min(rank, len(ordered))) - 1]


def percentile_or_none(values, q: float):
    """:func:`percentile_nearest_rank`, or None for an empty population:
    a table row where every request was rejected keeps its schema with
    null latency fields instead of crashing the summary."""
    return percentile_nearest_rank(values, q) if values else None
