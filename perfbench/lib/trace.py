"""The traced run: spans around the calls into the program's layers, and
the reduction of the profiler's device trace to the numbers that the
per-layer readers take.

Spans are ``torch.profiler.record_function`` ranges that the benchmark's
own files open around its calls into the program; each also keeps its
host-clock duration.  A device operation (kernel, copy or fill) belongs
to the span in whose host interval it was launched: its launch is the
CUDA runtime call with its correlation id, or else the CPU operator it
is linked to.  The harness does one thing at a time, so a launch's time
alone places it, on whichever thread (autograd's backward runs on a
worker thread of its own).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

#: Kineto activity types of work on the device.
DEVICE_ACTIVITIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
#: Kineto activity types of the host's calls into the CUDA runtime or
#: driver, whose correlation ids the device's operations carry.
LAUNCH_ACTIVITIES = ('cuda_runtime', 'cuda_driver')
#: Longest name kept in a breakdown.
NAME_CHARS = 160


class Spans:
    """Named spans around calls into the program.  Off, a span is a bare
    ``with``; on, it is a profiler range, and its host duration is kept
    by name."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.host_s: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        import torch
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.host_s[name].append(time.perf_counter() - t0)


class DeviceOp(NamedTuple):
    name: str
    kind: str
    start: int      # ns
    end: int
    launch: int     # ns on the host, -1 where no launch was found


class Interval(NamedTuple):
    name: str
    start: int
    end: int


class Trace:
    """A profiled window reduced to device operations, host spans and
    host operators, all in nanoseconds of one clock."""

    def __init__(self, ops: Sequence[DeviceOp], spans: Sequence[Interval],
                 host_ops: Sequence[Interval]):
        self.ops = sorted(ops, key=lambda o: o.start)
        self.spans = sorted(spans, key=lambda s: s.start)
        self.host_ops = sorted(host_ops, key=lambda s: s.start)
        launched = sorted((o for o in self.ops if o.launch >= 0),
                          key=lambda o: o.launch)
        self._launch_at = [o.launch for o in launched]
        self._launch_cum = [0]
        for o in launched:
            self._launch_cum.append(self._launch_cum[-1] + o.end - o.start)
        calls = [s for s in self.spans if s.name == 'call']
        self.window = ((calls[0].start, max(s.end for s in calls))
                       if calls else None)

    @classmethod
    def from_kineto(cls, events, span_names=()) -> 'Trace':
        """From ``profiler.kineto_results.events()``; *span_names* are the
        names of the benchmark's spans."""
        launches = {}
        cpu_ops = {}
        raw, spans, host_ops = [], [], []
        for e in events:
            kind = activity(e, span_names)
            start = e.start_ns()
            if kind in DEVICE_ACTIVITIES:
                raw.append((e, kind))
            elif kind in LAUNCH_ACTIVITIES:
                launches[e.correlation_id()] = start
            elif kind == 'user_annotation':
                spans.append(Interval(e.name(), start, end_ns(e)))
                cpu_ops[e.correlation_id()] = start
            elif kind == 'cpu_op':
                host_ops.append(Interval(e.name(), start, end_ns(e)))
                cpu_ops[e.correlation_id()] = start
        ops = []
        for e, kind in raw:
            launch = launches.get(e.correlation_id(),
                                  cpu_ops.get(e.linked_correlation_id(), -1))
            ops.append(DeviceOp(e.name(), kind, e.start_ns(), end_ns(e),
                                launch))
        return cls(ops, spans, host_ops)

    # -- the window --------------------------------------------------------
    def window_s(self) -> Optional[float]:
        if self.window is None:
            return None
        return (self.window[1] - self.window[0]) * 1e-9

    def _in_window(self, kinds=DEVICE_ACTIVITIES) -> List[DeviceOp]:
        lo, hi = self.window
        return [o for o in self.ops
                if o.kind in kinds and o.end > lo and o.start < hi]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        lo, hi = self.window
        merged: List[List[int]] = []
        for o in self._in_window():
            s, e = max(o.start, lo), min(o.end, hi)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> Optional[float]:
        if self.window is None:
            return None
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernels_in_window(self) -> List[DeviceOp]:
        return self._in_window(('kernel',))

    # -- spans -------------------------------------------------------------
    def launched_between(self, start: int, end: int) -> float:
        """Seconds of device work launched in the host interval."""
        i = bisect.bisect_left(self._launch_at, start)
        j = bisect.bisect_right(self._launch_at, end)
        return (self._launch_cum[j] - self._launch_cum[i]) * 1e-9

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the operations launched inside the spans
        named *name*; None if there is no such span."""
        spans = [s for s in self.spans if s.name == name]
        if not spans:
            return None
        return sum(self.launched_between(s.start, s.end) for s in spans)

    def device_s_by_name(self, pattern: str) -> Tuple[float, int]:
        """(seconds, count) of the window's kernels whose name holds
        *pattern*."""
        hits = [o for o in self.kernels_in_window() if pattern in o.name]
        return sum(o.end - o.start for o in hits) * 1e-9, len(hits)

    # -- the breakdown -----------------------------------------------------
    def top_device_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time in the window, summed
        by name."""
        total: Dict[str, int] = defaultdict(int)
        for o in self._in_window():
            total[o.name[:NAME_CHARS]] += o.end - o.start
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in ranked]

    def host_activity(self, t: int, max_steps: int = 20000) -> str:
        """The innermost span or operator running on the host at *t*
        (the latest-starting one that covers it)."""
        events = self._host_events()
        i = bisect.bisect_right(self._host_starts, t) - 1
        for _ in range(max_steps):
            if i < 0:
                break
            if events[i].end >= t:
                return events[i].name
            i -= 1
        return 'python (outside any span)'

    def _host_events(self) -> List[Interval]:
        if not hasattr(self, '_host_sorted'):
            self._host_sorted = sorted(list(self.spans) + list(self.host_ops),
                                       key=lambda s: s.start)
            self._host_starts = [s.start for s in self._host_sorted]
        return self._host_sorted

    def idle_gaps(self, n: int = 10, examined: int = 2000) -> List[list]:
        """Idle time of the device in the window, summed by what the host
        was doing at the middle of each gap: the *examined* longest gaps,
        the *n* names with most idle time."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, last = [], lo
        for s, e in busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if hi > last:
            gaps.append((last, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        total: Dict[str, int] = defaultdict(int)
        for s, e in gaps[:examined]:
            total[self.host_activity((s + e) // 2)[:NAME_CHARS]] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in ranked]


def end_ns(e) -> int:
    try:
        return e.end_ns()
    except AttributeError:
        return e.start_ns() + e.duration_ns()


def activity(e, span_names=()) -> str:
    """Kineto's activity type of an event.  Where the event does not say
    (``activity_type`` is newer than some PyTorch builds), it is read
    from the device and the name: copies and fills are named so, the
    benchmark's spans by *span_names*, and the host's CUDA runtime and
    driver calls start with ``cu``."""
    try:
        return e.activity_type()
    except AttributeError:
        pass
    name = e.name()
    flag = getattr(e, 'is_user_annotation', None)
    annotation = (flag() if flag is not None else False) or \
        name in span_names
    if e.device_type() == _cuda_device_type():
        if annotation:
            return 'gpu_user_annotation'
        if name.startswith('Memcpy'):
            return 'gpu_memcpy'
        if name.startswith('Memset'):
            return 'gpu_memset'
        return 'kernel'
    if annotation:
        return 'user_annotation'
    if name.startswith('cu'):
        return 'cuda_runtime'
    return 'cpu_op'


def _cuda_device_type():
    from torch.autograd import DeviceType
    return DeviceType.CUDA


def profile(cuda: bool = True):
    """A profiler of the host and, with *cuda*, the card, kept in
    memory."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events_of(prof):
    """The kineto events of a finished :func:`profile`."""
    return prof.profiler.kineto_results.events()
