"""Plain arithmetic of the benchmark: percentiles over all requests, the
union of device intervals, attribution of overlapping device time, and
the run-to-run spread that the bounds are set from.

The union and the attribution replace the sum of kernel durations that
the port's earlier profile helper (`chip_smoke.profile_execute`) took:
with programmatic dependent launch a kernel starts before the one it
waits for has ended, so the sum counts the overlap twice."""

from __future__ import annotations

import heapq
import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, by linear interpolation
    between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge [start, end] intervals into disjoint ones, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e < s:
            raise ValueError(f"interval ends before it starts: {(s, e)}")
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals) -> float:
    """Total length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def attribute(events: Sequence[Tuple[str, float, float]]) -> dict:
    """Time of the union of (name, start, end) events, split by name: each
    instant goes to the earliest-started event still running then (a
    kernel that started early only waits for the one before it). The
    values add up to the union's length."""
    points = sorted({t for _, s, e in events for t in (s, e)})
    order = sorted(range(len(events)), key=lambda i: events[i][1])
    heap: list = []
    out: dict = {}
    k = 0
    for a, b in zip(points, points[1:]):
        while k < len(order) and events[order[k]][1] <= a:
            i = order[k]
            heapq.heappush(heap, (events[i][1], i))
            k += 1
        while heap and events[heap[0][1]][2] <= a:
            heapq.heappop(heap)
        if heap:
            name = events[heap[0][1]][0]
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def innermost(spans: Sequence[Tuple[str, float, float]],
              points: Sequence[float]) -> List[str]:
    """For each point (ascending), the name of the latest-started span
    that covers it, or "" where none does."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    heap: list = []
    out = []
    k = 0
    for p in points:
        while k < len(order) and spans[order[k]][1] <= p:
            i = order[k]
            heapq.heappush(heap, (-spans[i][1], i))
            k += 1
        while heap and spans[heap[0][1]][2] < p:
            heapq.heappop(heap)
        out.append(spans[heap[0][1]][0] if heap else "")
    return out


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
