"""Arithmetic on a profiler's device intervals: the busy time (the union
of intervals, a frozen copy of the port's ``breakdown.busy_us``), the idle
gaps between them, the exposed time of one kind of work against another
(the port's ``halo_overlap.schedule``), the family of a kernel's name
(the port's ``trace_summary.family``), and the reductions the metric
readers share.  Every time is in microseconds on the profiler's clock; a
run's record (``run.run_cell``) holds one trace a card under ``trace``
and the bounds of the work its line sums required under ``work``."""

from __future__ import annotations

import re

import numpy as np


def busy_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, w0: float, w1: float) -> list:
    """The gaps [(start, end)] of the window [w0, w1] that no interval
    covers, in time order."""
    gaps, end = [], w0
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, w1)))
        end = max(end, e)
        if end >= w1:
            break
    if end < w1:
        gaps.append((end, w1))
    return [(s, e) for s, e in gaps if e > s]


def exposed_us(mine, others) -> float:
    """The time of the intervals ``mine`` during which none of ``others``
    runs: busy(mine + others) - busy(others)."""
    return busy_us(list(mine) + list(others)) - busy_us(others)


def family(name: str) -> str:
    """The family of a device kernel's name: without a leading ``void``,
    ``(anonymous namespace)::``, template arguments, the argument list and
    trailing digits and dots."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    while True:
        t = re.sub(r"<[^<>]*>", "", s)
        if t == s:
            break
        s = t
    s = s.split("(", 1)[0].strip()
    return re.sub(r"[.\d]+$", "", s).strip() or name


def idle_pct(rec) -> float:
    """The share of the traced window in which no operation ran on the
    device [%], the mean over the cards; None without a trace."""
    if not rec.get("trace"):
        return None
    shares = [1.0 - busy_us([(s, e) for _, s, e, _ in t["events"]])
              / t["window_us"] for t in rec["trace"]]
    return 100.0 * sum(shares) / len(shares)


def kernel_share(rec, kernels, work: str) -> float:
    """The bound of the required work ``rec["work"][work]`` [ms] over the
    device time of the kernels whose names hold one of ``kernels``, summed
    over the cards [%]; None where the run holds no such work or kernel."""
    if not rec.get("trace") or not rec.get("work") or not rec["work"][work]:
        return None
    us = sum(e - s for t in rec["trace"] for n, s, e, _ in t["events"]
             if any(k in n for k in kernels))
    return 100.0 * sum(rec["work"][work]) * 1e3 / us if us > 0 else None


def bound_share(rec) -> float:
    """The bound time of all the required line-sum work (K1 and K2) over
    the traced window times the cards [%]; None without a trace."""
    if not rec.get("trace") or not rec.get("work"):
        return None
    bound_ms = sum(rec["work"]["k1_ms"]) + sum(rec["work"]["k2_ms"])
    window_ms = sum(t["window_us"] for t in rec["trace"]) / 1e3
    return 100.0 * bound_ms / window_ms if window_ms > 0 else None
