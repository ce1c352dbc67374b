"""The arithmetic of the benchmark's numbers, in one place.

The run's window, the rates over it, the request tail, a roofline share,
the device's busy time from possibly overlapping intervals, and the
quartile spread that sets a bound.
"""
from __future__ import annotations

import math
import statistics


def rate_gbps(nbytes: int, seconds: float) -> float:
    """Bytes over seconds in GB/s (10^9 bytes a second)."""
    return nbytes / seconds / 1e9


def p95(values) -> float | None:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def roofline_pct(nbytes: float, peak_bytes_per_s: float,
                 device_s: float) -> float | None:
    """The share, in %, of ``device_s`` that moving ``nbytes`` at the peak
    rate would take; None where there is no device time to share."""
    if not device_s or device_s <= 0 or not peak_bytes_per_s:
        return None
    return 100.0 * nbytes / peak_bytes_per_s / device_s


def union(intervals) -> list[tuple[float, float]]:
    """Merge (start, end) intervals where they overlap or touch."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out = []
    t = lo
    for s, e in union(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``, its default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
