"""The readers of the program's own spans and counters on canned data:
idle time under a span counts every gap, short ones too, clipped at the
span's ends; a span found only among the host operators is read; device
time launched inside a span or an autograd node; the counter metrics
from the deltas of ``filter_functions_tpu_torch.tracing.counts`` over
the window; and every metric left out where the program has no such
span or counter."""
import sys
from pathlib import Path

import pytest

from filter_functions_tpu_torch import tracing
from perfbench.lib import manifest
from perfbench.lib.trace import DeviceOp, Interval, Trace

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000          # ns
NODE = 'autograd::engine::evaluate_function: _OzakiOuterBackward'
TRACE_METRICS = ('prep.idle_ms_per_pulse', 'contraction.idle_ms_per_pulse',
                 'ozaki.products.ms_per_pulse', 'backward.ozaki.ms_per_pulse')
COUNTER_METRICS = ('host.syncs_per_call', 'escalation.share')


class Run:
    def __init__(self, trace, pulses):
        self.trace, self.pulses = trace, pulses
        self.counters = {}


def metric(name):
    return manifest.module(ROOT, 'metrics', name)


def ms(x: float) -> int:
    return int(round(x * MS))


def canned(program: bool = True) -> Trace:
    """Two calls over [0, 10] ms.  Kernels at [1, 2] and [2.001, 3] (a
    1-us gap), [6, 7], a copy at [8, 8.5]: idle [0, 1], [2, 2.001],
    [3, 6], [7, 8], [8.5, 10].  With *program*: ``ff.contract`` over
    [0.5, 4] and, nested in it under the same name, [0.6, 0.7];
    ``ff.ozaki.products`` over [0.9, 2.5], launching the first two
    kernels; ``ff.prep`` over [5, 7.5] among the host operators only;
    the Ozaki backward node over [5.5, 5.9], launching [6, 7]."""
    ops = [DeviceOp('int8_gemm', 'kernel', ms(1), ms(2), ms(0.95)),
           DeviceOp('ds_add', 'kernel', ms(2.001), ms(3), ms(1.9)),
           DeviceOp('cf64_gemm', 'kernel', ms(6), ms(7), ms(5.6)),
           DeviceOp('Memcpy DtoH', 'gpu_memcpy', ms(8), ms(8.5), ms(7.6))]
    spans = [Interval('call', 0, ms(4)), Interval('call', ms(4), ms(10))]
    host = [Interval('aten::item', ms(8.6), ms(9.9))]
    if program:
        spans += [Interval('ff.contract', ms(0.5), ms(4)),
                  Interval('ff.contract', ms(0.6), ms(0.7)),
                  Interval('ff.ozaki.products', ms(0.9), ms(2.5))]
        host += [Interval('ff.prep', ms(5), ms(7.5)),
                 Interval(NODE, ms(5.5), ms(5.9))]
    return Trace(ops, spans, host)


def test_idle_under_a_span_counts_every_gap_and_clips():
    """ff.contract: [0.5, 1] + [2, 2.001] + [3, 4] (the nested span of
    the same name counted once); ff.prep, a host operator: [5, 6] +
    [7, 7.5]."""
    run = Run(canned(), 4)
    assert metric('contraction.idle_ms_per_pulse').read(run) == \
        pytest.approx(1.501 / 4)
    assert metric('prep.idle_ms_per_pulse').read(run) == \
        pytest.approx(1.5 / 4)


def test_idle_under_spans_is_within_the_windows_idle():
    trace = canned()
    run = Run(trace, 4)
    idle_ms = 1e3 * (trace.window_s() - trace.busy_s())
    spanned = sum(metric(name).read(run) for name in
                  ('prep.idle_ms_per_pulse', 'contraction.idle_ms_per_pulse'))
    assert spanned * 4 <= idle_ms


def test_device_time_launched_inside_a_span_or_node():
    run = Run(canned(), 4)
    assert metric('ozaki.products.ms_per_pulse').read(run) == \
        pytest.approx(1.999 / 4)
    assert metric('backward.ozaki.ms_per_pulse').read(run) == \
        pytest.approx(1.0 / 4)


@pytest.mark.parametrize('name', TRACE_METRICS)
def test_trace_metrics_left_out_without_the_spans(name):
    assert metric(name).read(Run(canned(program=False), 4)) is None
    assert metric(name).read(Run(None, 4)) is None


def _window(run, counts):
    """The counter metrics' instruments around a window in which the
    program adds *counts*."""
    close = [metric(name).instrument(run) for name in COUNTER_METRICS]
    tracing.counts.update(counts)
    for fn in close:
        fn()


def test_counter_metrics_from_the_windows_deltas():
    """Counts from before the window are not the window's: two calls,
    each with one escalation read and two degenerate checks, one of the
    two decisions escalated."""
    tracing.counts['sync.escalation'] += 5
    run = Run(canned(), 4)
    _window(run, {'sync.escalation': 2, 'sync.degenerate': 4,
                  'escalation.decisions': 2, 'escalation.escalated': 1})
    assert metric('host.syncs_per_call').read(run) == 3.0
    assert metric('escalation.share').read(run) == 50.0


def test_escalation_share_left_out_without_a_decision():
    run = Run(canned(), 4)
    _window(run, {'sync.degenerate': 2})
    assert metric('escalation.share').read(run) is None
    assert metric('host.syncs_per_call').read(run) == 1.0


@pytest.mark.parametrize('name', COUNTER_METRICS)
def test_counter_metrics_left_out_without_the_counters(name, monkeypatch):
    """A program without ``tracing``: the instrument records nothing."""
    monkeypatch.setitem(sys.modules, 'filter_functions_tpu_torch.tracing',
                        None)
    run = Run(canned(), 4)
    metric(name).instrument(run)()
    assert metric(name).read(run) is None
