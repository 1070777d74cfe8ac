"""The readers of the program's spans of the second-order shifts' parts
(``ff.so.steps``, ``ff.so.sandwich``) and of its backward stages
(``ff.etm.backward``, ``ff.etm.cumulant.backward``,
``ff.so.sandwich.backward``, ``ff.etm.steps.backward``,
``ff.prep.backward``) on a canned trace: device time launched inside a
range and idle time inside it, every gap counted; the ranges read alike
where the trace classes them as host operators; a range nested in one
of its own name counted once; each metric left out where the program
has no such range, and reported by the cells that list it."""
from pathlib import Path

import pytest

from perfbench.lib import manifest
from perfbench.lib.trace import DeviceOp, Interval, Trace

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000          # ns
ETM_CELLS = ('qft4_etm2.jitter4', 'qft4_etm2_xcorr.jitter4',
             'qft4_etm2_grape.step4')
GRAPE = ('qft4_etm2_grape.step4',)
#: metric: (its value in ms a pulse on :func:`canned`, the cells that
#: report it)
EXPECTED = {
    'so.steps.ms_per_pulse': (0.8 / 4, ETM_CELLS),
    'so.sandwich.ms_per_pulse': (1.1 / 4, ETM_CELLS),
    'etm.backward.idle_ms_per_pulse': (6.0 / 4, GRAPE),
    'etm.cumulant.backward.ms_per_pulse': (1.0 / 4, GRAPE),
    'etm.cumulant.backward.idle_ms_per_pulse': (0.5 / 4, GRAPE),
    'so.sandwich.backward.ms_per_pulse': (1.0 / 4, GRAPE),
    'so.sandwich.backward.idle_ms_per_pulse': (1.0 / 4, GRAPE),
    'etm.steps.backward.ms_per_pulse': (0.8 / 4, GRAPE),
    'etm.steps.backward.idle_ms_per_pulse': (0.2 / 4, GRAPE),
    'prep.backward.ms_per_pulse': (1.0 / 4, ('qft4.gradient',) + GRAPE),
    'prep.backward.idle_ms_per_pulse': (1.0 / 4,
                                        ('qft4.gradient',) + GRAPE),
}


class Run:
    def __init__(self, trace, pulses):
        self.trace, self.pulses = trace, pulses
        self.counters = {}


def metric(name):
    return manifest.module(ROOT, 'metrics', name)


def ms(x: float) -> int:
    return int(round(x * MS))


def canned(program: bool = True, host: bool = False) -> Trace:
    """One call of 4 pulses over [0, 20] ms.  The forward: ``ff.so.steps``
    [2, 3] launching [2.1, 2.9]; ``ff.so.tables`` [3, 4] launching [3.1,
    3.8]; ``ff.so.sandwich`` [4, 5] launching [4.1, 4.6] and, from
    another ``ff.so.sandwich`` [4.4, 4.6] nested in it, [4.7, 4.9], and
    ``ff.so.sandwich`` [5, 5.8] launching [5.2, 5.6].  The benchmark's
    ``backward`` [8, 19.5] holds, on autograd's thread (a launch is
    placed by its time alone), ``ff.etm.backward`` [8.2, 19] and in it
    ``ff.etm.cumulant.backward`` [8.5, 10] launching [8.6, 9.6],
    ``ff.so.sandwich.backward`` [10, 11] and [12, 13] launching [10.2,
    10.7] and [12.3, 12.8], ``ff.so.tables.backward`` [11, 12] launching
    [11.1, 11.9], an unmarked node launching [13.2, 13.4],
    ``ff.etm.steps.backward`` [14, 15] launching [14.2, 15],
    ``ff.prep.backward`` [16, 18] launching [16.1, 16.6] and, from a
    ``ff.prep.backward`` [16.7, 16.9] nested in it, [17, 17.5]; the
    loss's backward launches [19.2, 19.4] outside ``ff.etm.backward``.
    With *host* the program's ranges are host operators, not spans."""
    launched = [(2.1, 2.9, 2.05), (3.1, 3.8, 3.05), (4.1, 4.6, 4.05),
                (4.7, 4.9, 4.5), (5.2, 5.6, 5.1), (8.6, 9.6, 8.55),
                (10.2, 10.7, 10.1), (11.1, 11.9, 11.05), (12.3, 12.8, 12.2),
                (13.2, 13.4, 13.1), (14.2, 15.0, 14.1), (16.1, 16.6, 16.05),
                (17.0, 17.5, 16.8), (19.2, 19.4, 19.1)]
    ops = [DeviceOp('kernel', 'kernel', ms(s), ms(e), ms(at))
           for s, e, at in launched]
    spans = [Interval('call', 0, ms(20)), Interval('forward', 0, ms(8)),
             Interval('backward', ms(8), ms(19.5))]
    ranges = [('ff.so.steps', 2, 3), ('ff.so.tables', 3, 4),
              ('ff.so.sandwich', 4, 5), ('ff.so.sandwich', 4.4, 4.6),
              ('ff.so.sandwich', 5, 5.8), ('ff.etm.backward', 8.2, 19),
              ('ff.etm.cumulant.backward', 8.5, 10),
              ('ff.so.sandwich.backward', 10, 11),
              ('ff.so.tables.backward', 11, 12),
              ('ff.so.sandwich.backward', 12, 13),
              ('ff.etm.steps.backward', 14, 15),
              ('ff.prep.backward', 16, 18), ('ff.prep.backward', 16.7, 16.9)]
    found = [Interval(name, ms(s), ms(e)) for name, s, e in ranges]
    if not program:
        found = [r for r in found if r.name == 'ff.so.tables']
    if host:
        return Trace(ops, spans, found)
    return Trace(ops, spans + found, [])


@pytest.mark.parametrize('host', [False, True], ids=['spans', 'host_ops'])
@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_reads_the_programs_range(name, host):
    """Device time and idle inside the named ranges a pulse, the nested
    ones of the same name counted once, alike wherever the trace classes
    them."""
    want, _ = EXPECTED[name]
    assert metric(name).read(Run(canned(host=host), 4)) == \
        pytest.approx(want)


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_left_out_without_the_range(name):
    """A program that opens no such range, or a run without a trace:
    the metric is left out."""
    assert metric(name).read(Run(canned(program=False), 4)) is None
    assert metric(name).read(Run(None, 4)) is None


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_reported_by_the_cells_that_list_it(name):
    _, cells = EXPECTED[name]
    manifest_ = manifest.load_manifest(ROOT)
    for w in manifest_['workloads']:
        reported = name in {m['name'] for m in
                            manifest.cell(ROOT, w['name'], manifest_)
                            .per_layer}
        assert reported == (w['name'] in cells), w['name']
