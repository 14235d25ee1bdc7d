"""Percentiles and interval unions: the yardstick's statistics."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of all `values`: the value
    at rank round(q / 100 * (n - 1)) of the sorted list (a copy of the
    port's `StepTimer.percentile`)."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of closed intervals (start, end)."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if b < a:
            raise ValueError(f"interval ends before it starts: {(a, b)}")
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length of [lo, hi] that the intervals cover, overlaps counted once."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]
