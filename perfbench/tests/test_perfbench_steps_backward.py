"""The reader of ``so.steps.backward.ms_per_pulse`` on a synthetic
trace: the device time launched inside the program's
``ff.so.steps.backward`` spans a pulse, left out without them, and
reported by the ``qft4_etm2_grape.step4`` cell alone."""
from pathlib import Path

import pytest

from perfbench.lib import manifest
from perfbench.lib.trace import DeviceOp, Interval, Trace

ROOT = Path(__file__).resolve().parents[2]
NAME = 'so.steps.backward.ms_per_pulse'
CELL = 'qft4_etm2_grape.step4'
MS = 1_000_000          # ns


class Run:
    def __init__(self, trace, pulses):
        self.trace, self.pulses = trace, pulses
        self.counters = {}


def ms(x: float) -> int:
    return int(round(x * MS))


def synthetic(program: bool = True) -> Trace:
    """One call over [0, 10] ms: ``backward`` [3, 9.5] launching a
    0.5-ms kernel and holding ``ff.so.steps.backward`` [4, 6] with
    kernels of 1.0 and 0.4 ms (launched on autograd's thread: the trace
    places a launch by its time alone), and ``ff.so.tables.backward``
    [7, 8] with one of 0.6 ms."""
    ops = [DeviceOp('mul', 'kernel', ms(3.1), ms(3.6), ms(3.05)),
           DeviceOp('zgemm', 'kernel', ms(4.2), ms(5.2), ms(4.1)),
           DeviceOp('mul', 'kernel', ms(5.6), ms(6.0), ms(5.55)),
           DeviceOp('dgemm', 'kernel', ms(7.2), ms(7.8), ms(7.1))]
    spans = [Interval('call', 0, ms(10)), Interval('backward', ms(3), ms(9.5)),
             Interval('ff.so.tables.backward', ms(7), ms(8))]
    if program:
        spans.append(Interval('ff.so.steps.backward', ms(4), ms(6)))
    return Trace(ops, spans, [])


def metric():
    return manifest.module(ROOT, 'metrics', NAME)


def test_reads_the_span():
    assert metric().read(Run(synthetic(), 4)) == pytest.approx(1.4 / 4)


def test_left_out_without_the_program_span():
    """A program that opens no such span, or a run without a trace:
    the metric is left out."""
    assert metric().read(Run(synthetic(program=False), 4)) is None
    assert metric().read(Run(None, 4)) is None


def test_only_the_grape_cell_reports_it():
    assert NAME in {m['name'] for m in manifest.cell(ROOT, CELL).per_layer}
    for name in ('qft4.infidelity', 'qft4.gradient', 'qft4_etm2.jitter4',
                 'qft4_etm2_xcorr.jitter4'):
        assert NAME not in {m['name']
                            for m in manifest.cell(ROOT, name).per_layer}
