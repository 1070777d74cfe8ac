"""What the per-layer readers of the program's own spans and counters
share (``filter_functions_tpu_torch.tracing``).

A span is looked up by its exact name among the trace's spans and its
host operators both: ``trace.activity`` may class a range opened by the
program either way.  Where the program has no such span, or no such
counters, each helper returns None and its metric is left out.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

#: Key of the counter deltas of the window in ``run.counters``.
COUNTS = 'tracing.counts'


def intervals(trace, name: str) -> List[Tuple[int, int]]:
    """The union of the host intervals named *name*, sorted."""
    found = sorted((s.start, s.end) for s in list(trace.spans)
                   + list(trace.host_ops) if s.name == name)
    merged: List[List[int]] = []
    for s, e in found:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_gaps(trace) -> List[Tuple[int, int]]:
    """Every interval of the window in which no device operation runs."""
    lo, hi = trace.window
    gaps, last = [], lo
    for s, e in trace.busy_intervals():
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if hi > last:
        gaps.append((last, hi))
    return gaps


def idle_under_s(trace, name: str) -> Optional[float]:
    """Seconds of the window's device idle time inside the host
    intervals of the spans named *name*; None without such a span."""
    if trace is None or trace.window is None:
        return None
    spans = intervals(trace, name)
    if not spans:
        return None
    gaps = idle_gaps(trace)
    total, i = 0, 0
    for s, e in spans:
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            total += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return total * 1e-9


def launched_under_s(trace, name: str) -> Optional[float]:
    """Device seconds of the operations launched inside the host
    intervals named *name*; None without such an interval."""
    if trace is None:
        return None
    spans = intervals(trace, name)
    if not spans:
        return None
    return sum(trace.launched_between(s, e) for s, e in spans)


def per_pulse_ms(run, seconds: Optional[float]) -> Optional[float]:
    if seconds is None or not run.pulses:
        return None
    return 1e3 * seconds / run.pulses


def instrument(run):
    """Snapshots the program's counters before the window; the returned
    function, called when the window closes, keeps their deltas under
    :data:`COUNTS`.  A program without them records nothing."""
    try:
        from filter_functions_tpu_torch.tracing import counts
    except ImportError:
        return lambda: None
    before = dict(counts)

    def close():
        run.counters[COUNTS] = {k: counts[k] - before.get(k, 0)
                                for k in set(counts) | set(before)}
    return close


def calls(trace) -> int:
    """The calls of the traced window: its ``call`` spans."""
    return sum(s.name == 'call' for s in trace.spans)
