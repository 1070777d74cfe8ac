"""The metric arithmetic on canned data: the idle share of a trace with
overlapping operations, the device time of spans, the roofline of
``dword_digits`` at the flagship's shape, and the tail and the rate of a
window that holds a stall."""
import pytest

from perfbench.lib import manifest, roofline, stats
from perfbench.lib.trace import DeviceOp, Interval, Trace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000          # ns


class Run:
    def __init__(self, trace, pulses, counters=None, spans=None):
        self.trace, self.pulses = trace, pulses
        self.counters = counters or {}
        self.spans = spans


def metric(name):
    return manifest.module(ROOT, 'metrics', name)


def canned() -> Trace:
    """A window of 10 ms (two calls); kernels at [1, 3], [2, 4] (they
    overlap), [6, 7] and a copy at [8, 8.5]; one kernel outside the
    window.  Launches: 0.5, 1.5, 5.5, 7.5 ms; the contraction span runs
    from 1 to 2 ms, the prep span from 5 to 6 ms."""
    ops = [DeviceOp('gemm', 'kernel', 1 * MS, 3 * MS, int(0.5 * MS)),
           DeviceOp('dword_digits_kernel<5>', 'kernel', 2 * MS, 4 * MS,
                    int(1.5 * MS)),
           DeviceOp('eigh', 'kernel', 6 * MS, 7 * MS, int(5.5 * MS)),
           DeviceOp('Memcpy DtoH', 'gpu_memcpy', 8 * MS, int(8.5 * MS),
                    int(7.5 * MS)),
           DeviceOp('late', 'kernel', 12 * MS, 13 * MS, 11 * MS)]
    spans = [Interval('call', 0, 4 * MS), Interval('call', 4 * MS, 10 * MS),
             Interval('contraction', 1 * MS, 2 * MS),
             Interval('prep', 5 * MS, 6 * MS)]
    host = [Interval('aten::item', int(8.6 * MS), int(9.9 * MS))]
    return Trace(ops, spans, host)


def test_idle_share_counts_overlaps_once():
    trace = canned()
    assert trace.window_s() == pytest.approx(10e-3)
    # busy: [1, 4] + [6, 7] + [8, 8.5] = 4.5 ms of 10
    assert trace.busy_s() == pytest.approx(4.5e-3)
    assert metric('device.idle_pct').read(Run(trace, 4)) == \
        pytest.approx(55.0)


def test_kernels_per_pulse_counts_the_windows_kernels():
    assert metric('device.kernels_per_pulse').read(Run(canned(), 2)) == 1.5


def test_span_device_time_goes_by_launch():
    trace = canned()
    assert trace.span_device_s('contraction') == pytest.approx(2e-3)
    assert metric('contraction.ms_per_pulse').read(Run(trace, 4)) == \
        pytest.approx(0.5)
    assert metric('prep.ms_per_pulse').read(Run(trace, 4)) == \
        pytest.approx(0.25)
    assert metric('backward.ms_per_pulse').read(Run(trace, 4)) is None


def test_idle_gaps_are_named_by_the_host():
    gaps = dict(canned().idle_gaps())
    assert gaps['aten::item'] == pytest.approx(1.5e-3)     # [8.5, 10]
    assert gaps['call'] == pytest.approx(2e-3)             # [0, 1], [7, 8]
    assert gaps['prep'] == pytest.approx(2e-3)             # [4, 6], at 5


def test_dword_bound_at_the_flagships_shape():
    """One call of 2 flagship pulses (K = 13 x 16 x 16, 18 noise
    operators, 256 basis elements, 5 digits): 474.8 MB, 0.1417 ms."""
    assert roofline.dword_digits_bytes(3328, 18, 256, 5, 2) == 474763264
    assert roofline.dword_digits_bound_s(3328, 18, 256, 5, 2) == \
        pytest.approx(0.1417e-3, rel=1e-3)


def test_dword_roofline_over_its_kernels():
    """Two launches at the flagship's shape over 2 ms of the kernel."""
    shape = (2, 3328, 18, 256, 5)
    reader = metric('dword_digits_roofline')
    run = Run(canned(), 4, {reader.COUNTER: [shape]})
    bound = roofline.dword_digits_bound_s(3328, 18, 256, 5, 2)
    assert reader.read(run) == pytest.approx(100 * bound / 2e-3)
    # a launch recorded that the trace does not hold: nothing to read
    run.counters[reader.COUNTER] = [shape, shape]
    assert reader.read(run) is None


def test_tail_and_rate_of_a_window_with_a_stall():
    """199 calls of 100 ms and one stall of 2 s: the p95 stays a normal
    call's, the rate counts the stall's time."""
    calls = [100.0] * 199 + [2000.0]
    assert stats.percentile(calls, 95) == 100.0
    assert stats.percentile(calls, 99.5) == 100.0
    assert stats.percentile(calls, 100) == 2000.0
    seconds = sum(calls) / 1e3
    assert stats.rate(200 * 8, seconds) == pytest.approx(1600 / 21.9)
    # 20 stalls: the p95 is a stall's
    assert stats.percentile([100.0] * 180 + [2000.0] * 20, 95) == 2000.0


def test_spread_is_the_interquartile_share():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([90.0, 95.0, 100.0, 105.0, 110.0]) == \
        pytest.approx(15 / 100)
