"""Window statistics: rates to the last completed unit, the union of device
intervals and the idle gaps between them, and the run-to-run spread that
sets a bound."""

from __future__ import annotations

import statistics


def window_rate(units, t_start: float) -> float:
    """Units per second over a window: ``units`` is a list of (amount,
    t_end), one per completed unit (a batch, a step), with t_end on the
    clock of ``t_start``.  The rate is every unit's amount over the time
    from the window's start to the end of the last unit."""
    if not units:
        raise ValueError("no unit completed in the window")
    last = max(t for _, t in units)
    if last <= t_start:
        raise ValueError("the last unit ends before the window starts")
    return sum(a for a, _ in units) / (last - t_start)


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``intervals`` ((start, end) pairs) clipped to [lo, hi],
    as sorted disjoint pairs."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` inside [lo, hi]."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def spread(values) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
