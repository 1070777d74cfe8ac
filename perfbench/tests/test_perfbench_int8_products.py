"""The reader of ``int8_products_roofline`` on a synthetic run: the
window's ``ozaki.int8_ops`` delta over the device time launched inside
``ff.ozaki.products``, against the int8 peak; left out where the
program has no such counter or span."""
import sys
from pathlib import Path

import pytest

from filter_functions_tpu_torch import tracing
from perfbench.lib import manifest
from perfbench.lib.trace import DeviceOp, Interval, Trace

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000          # ns
NAME = 'int8_products_roofline'
#: int8 operations of the cells' call: two pulses, 3 x 15 slice pairs of
#: 2 x 1000 x 3328 x 4608
CALL_OPS = 2 * 3 * 15 * 2 * 1000 * 3328 * 4608


class Run:
    def __init__(self, trace):
        self.trace, self.pulses = trace, 4
        self.counters = {}


def metric():
    return manifest.module(ROOT, 'metrics', NAME)


def synthetic(spans: bool = True) -> Trace:
    """Two calls over [0, 10] ms: a products kernel of 2.5 ms launched
    inside each ``ff.ozaki.products`` span, and a kernel outside them."""
    ops = [DeviceOp('ozaki_products_kernel', 'kernel', ms(1), ms(3.5),
                    ms(0.9)),
           DeviceOp('ozaki_products_kernel', 'kernel', ms(5), ms(7.5),
                    ms(4.9)),
           DeviceOp('eigh', 'kernel', ms(8), ms(9), ms(7.8))]
    names = [Interval('call', 0, ms(4)), Interval('call', ms(4), ms(10))]
    if spans:
        names += [Interval('ff.ozaki.products', ms(0.8), ms(1.0)),
                  Interval('ff.ozaki.products', ms(4.8), ms(5.0))]
    return Trace(ops, names, [])


def ms(x: float) -> int:
    return int(round(x * MS))


def window(run, ops: int):
    close = metric().instrument(run)
    tracing.counts['ozaki.int8_ops'] += ops
    close()


def test_share_of_the_int8_peak():
    """Two calls' operations in 5 ms of kernel time; counts from before
    the window are not the window's."""
    tracing.counts['ozaki.int8_ops'] += 12345
    run = Run(synthetic())
    window(run, 2 * CALL_OPS)
    want = 100 * 2 * CALL_OPS / 5e-3 / 1.979e15
    assert metric().read(run) == pytest.approx(want)
    assert 0 < metric().read(run) <= 100


def test_left_out_without_the_span():
    run = Run(synthetic(spans=False))
    window(run, 2 * CALL_OPS)
    assert metric().read(run) is None
    assert metric().read(Run(None)) is None


def test_left_out_without_the_counter(monkeypatch):
    """A program whose tracing has no ``ozaki.int8_ops`` (the parent of
    the kernel), or no tracing at all."""
    run = Run(synthetic())
    window(run, 0)
    assert metric().read(run) is None
    monkeypatch.setitem(sys.modules, 'filter_functions_tpu_torch.tracing',
                        None)
    run = Run(synthetic())
    metric().instrument(run)()
    assert metric().read(run) is None
