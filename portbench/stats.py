"""Statistics of a run: percentiles over all requests, and the device's
busy time and idle gaps from a timeline of intervals."""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-th quantile (0 < q <= 1) by nearest rank: an observed value,
    the ceil(q * n)-th smallest."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(math.ceil(q * len(s)), 1) - 1]


def latency_quantile(latencies: Sequence[Optional[float]], q: float,
                     miss: float) -> float:
    """The q-th quantile over every request sent; a request that failed or
    never resolved (None) counts as ``miss``, a time past any limit."""
    return nearest_rank([miss if t is None else t for t in latencies], q)


def merge(intervals: Sequence[Interval], t0: float, t1: float
          ) -> List[Interval]:
    """The union of ``intervals`` clipped to [t0, t1], as sorted disjoint
    intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals: Sequence[Interval], t0: float, t1: float) -> float:
    """Time in [t0, t1] covered by at least one interval."""
    return sum(b - a for a, b in merge(intervals, t0, t1))


def gaps(intervals: Sequence[Interval], t0: float, t1: float
         ) -> List[Interval]:
    """The stretches of [t0, t1] that no interval covers."""
    out, t = [], t0
    for a, b in merge(intervals, t0, t1):
        if a > t:
            out.append((t, a))
        t = b
    if t < t1:
        out.append((t, t1))
    return out


class Spans:
    """Host spans of one name, for the question "was one open at time t"
    (each name's spans are disjoint: one thread opens them)."""

    def __init__(self, spans: Sequence[Interval]):
        merged = merge(spans, -math.inf, math.inf)
        self._starts = [a for a, _ in merged]
        self._ends = [b for _, b in merged]

    def open_at(self, t: float) -> bool:
        i = bisect.bisect_right(self._starts, t) - 1
        return i >= 0 and t < self._ends[i]


def name_gaps(gap_list: Sequence[Interval], spans: Dict[str, Sequence[
        Interval]], order: Sequence[str], rest: str) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap goes to the first
    name of ``order`` whose span was open at the gap's midpoint, else to
    ``rest``."""
    index = {k: Spans(spans.get(k, ())) for k in order}
    out: Dict[str, float] = {}
    for a, b in gap_list:
        mid = 0.5 * (a + b)
        name = next((k for k in order if index[k].open_at(mid)), rest)
        out[name] = out.get(name, 0.0) + (b - a)
    return out

