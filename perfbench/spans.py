"""The program's spans in a device trace, and the device's idle time under
them.

The port marks its phases with ``record_function`` ranges while a
profiler runs (``utils/profiling.annotate``: ``mmnm.fused.batches``,
``mmnm.step`` and the rest). They sit in ``Trace.host`` as
``user_annotation`` events of the window's thread, on the clock of the
device's events. A family is a set of span names:

  * ``durations``  each span's length in seconds, in the order they began
  * ``idle_s``     the device's idle time (``Trace.gaps``) inside the
                   union of the family's spans: an exact intersection of
                   the two unions, each idle instant counted once

They give nothing (an empty list, None) where the trace holds none of the
family's spans, as in a trace of a program without them; ``idle_pct`` and
``mean``, which the metric readers call, also where the run was not
traced.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def _spans(trace, names: Iterable[str]) -> List[Interval]:
    names = set(names)
    return [(start, end) for start, end, name, cat in trace.host
            if cat == "user_annotation" and name in names]


def durations(trace, *names: str) -> List[float]:
    return [(end - start) * 1e-6 for start, end in _spans(trace, names)]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def overlap_s(a: List[Interval], b: List[Interval]) -> float:
    """The length in seconds of the intersection of two sorted lists of
    disjoint intervals (us)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total * 1e-6


def idle_s(trace, *names: str) -> Optional[float]:
    spans = _spans(trace, names)
    if not spans:
        return None
    return overlap_s(union(trace.gaps()), union(spans))


def idle_pct(ctx, *names: str) -> Optional[float]:
    """``idle_s`` over the traced sub-window, in %."""
    if ctx.trace is None:
        return None
    idle = idle_s(ctx.trace, *names)
    return None if idle is None else 100.0 * idle / ctx.trace.window_s


def mean(ctx, name: str, scale: float) -> Optional[float]:
    """The mean duration of the span ``name`` in the traced sub-window,
    times ``scale`` (1e3 for ms, 1e6 for us)."""
    if ctx.trace is None:
        return None
    values = durations(ctx.trace, name)
    return scale * sum(values) / len(values) if values else None
