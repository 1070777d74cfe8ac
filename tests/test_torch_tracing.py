"""The port's spans and counters (filter_functions_tpu_torch.tracing):
the spans appear, nested as documented, only under a profiler and
change no value; the counters count each read of the device and each
escalation decision at its site, and the int8 operations of the Ozaki
slice products."""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from filter_functions_tpu_torch import functional, numeric, tracing
from filter_functions_tpu_torch.basis import Basis
from torch_testutil import record_lattice_rows

D, G, BATCH, CHUNK = 4, 80, 4, 2     # K = G d^2 = 1280: the deep route
OZAKI_NODE = 'autograd::engine::evaluate_function: _OzakiOuterBackward'
#: int8 operations of the slice products of one pulse: 3 Gauss products
#: of 15 slice pairs (7-bit slices, 5 levels), each 2 M K N with M = 11
#: frequencies, K = G d^2 and N = 1 noise operator times d^2 basis
#: elements
PULSE_INT8_OPS = 3 * 15 * 2 * 11 * (G * D * D) * (D * D)


def _herm(n, rng):
    a = rng.standard_normal((n, D, D)) + 1j * rng.standard_normal((n, D, D))
    h = a + a.conj().transpose(0, 2, 1)
    return h - np.trace(h, axis1=1, axis2=2)[:, None, None] * np.eye(D) / D


@pytest.fixture(scope='module')
def pulse():
    """Random d = 4 pulses of 80 segments, 2 control and 1 noise
    operators, and 11 frequencies with a 1/omega spectrum."""
    rng = np.random.default_rng(17)
    p = functional.PulseArrays(
        torch.tensor(_herm(2, rng)),
        torch.tensor(rng.standard_normal((BATCH, 2, G))),
        torch.tensor(_herm(1, rng)),
        torch.tensor(rng.random((BATCH, 1, G))),
        torch.tensor(1 - rng.random((BATCH, G))),
        Basis.ggm(D).tensor('cpu'))
    omega = torch.tensor(np.linspace(0.1, 10, 11))
    return p, 1e-3 / omega, omega


def _profiled(fn):
    """fn() under a CPU profiler: (its value, the kineto events)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, list(prof.profiler.kineto_results.events())


def _ranges(events, name):
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if e.name() == name)


@contextlib.contextmanager
def _delta():
    """The changes of tracing.counts inside the block."""
    before = dict(tracing.counts)
    out = {}
    yield out
    for key in set(tracing.counts) | set(before):
        if tracing.counts[key] != before.get(key, 0):
            out[key] = tracing.counts[key] - before.get(key, 0)


def test_span_is_inert_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert isinstance(tracing.span('ff.test'), contextlib.nullcontext)


def test_span_is_a_range_under_a_profiler():
    def fn():
        assert torch.autograd._profiler_enabled()
        with tracing.span('ff.test'):
            return torch.ones(3).sum()
    _, events = _profiled(fn)
    assert len(_ranges(events, 'ff.test')) == 1


def test_spans_of_the_batched_infidelity(pulse):
    """Per chunk one ff.prep and one ff.contract, in turn, with one
    ff.ozaki.products inside each ff.contract; the infidelities bit for
    bit those without a profiler."""
    p, spectrum, omega = pulse

    def fn():
        return functional.batched_infidelity(p, spectrum, omega,
                                             chunk_size=CHUNK,
                                             contract='ozaki')
    off = fn()
    on, events = _profiled(fn)
    assert torch.equal(on, off)
    prep = _ranges(events, 'ff.prep')
    contract = _ranges(events, 'ff.contract')
    products = _ranges(events, 'ff.ozaki.products')
    chunks = BATCH // CHUNK
    assert len(prep) == len(contract) == len(products) == chunks
    for k in range(chunks):
        assert prep[k][1] <= contract[k][0]
        assert contract[k][0] <= products[k][0] <= products[k][1] \
            <= contract[k][1]
        if k + 1 < chunks:
            assert contract[k][1] <= prep[k + 1][0]


def test_backward_shows_the_ozaki_node(pulse):
    """Autograd's own range around the factored product's backward
    node, one per chunk; the gradient bit for bit that without a
    profiler."""
    p, spectrum, omega = pulse

    def fn():
        cc = p.c_coeffs.clone().requires_grad_(True)
        infid = functional.batched_infidelity(
            p._replace(c_coeffs=cc), spectrum, omega, chunk_size=CHUNK,
            contract='ozaki')
        return torch.autograd.grad(infid.sum(), cc)[0]
    off = fn()
    on, events = _profiled(fn)
    assert torch.equal(on, off)
    assert len(_ranges(events, OZAKI_NODE)) == BATCH // CHUNK


@pytest.mark.parametrize('tol, decisions, escalated', [
    (None, 1, 0), (1e-30, 1, 1), (0, 0, 0)],
    ids=['default', 'tiny', 'off'])
def test_escalation_counts(pulse, tol, decisions, escalated):
    """One read and one decision per call (none with the check off);
    a tiny threshold escalates."""
    p, spectrum, omega = pulse
    kw = {} if tol is None else {'escalation_tol': tol}
    with _delta() as got:
        functional.batched_infidelity(p, spectrum, omega, chunk_size=CHUNK,
                                      contract='ozaki', **kw)
    want = {'sync.escalation': decisions,
            'escalation.decisions': decisions,
            'escalation.escalated': escalated,
            'ozaki.int8_ops': BATCH * PULSE_INT8_OPS}
    assert got == {k: v for k, v in want.items() if v}


@pytest.mark.parametrize('grad', [False, True], ids=['no_grad', 'grad'])
@pytest.mark.parametrize('degenerate', [False, True],
                         ids=['distinct', 'degenerate'])
def test_degenerate_check_counts(pulse, grad, degenerate):
    """The degenerate-eigenspace check reads the device once per chunk
    where a gradient reaches the Hamiltonians, whether or not a
    segment is degenerate; without one it reads nothing."""
    p, spectrum, omega = pulse
    cc = p.c_coeffs.clone()
    if degenerate:
        cc[..., :5] = 0           # H = 0: one eigenspace of dimension d
    cc.requires_grad_(grad)
    with _delta() as got:
        infid = functional.batched_infidelity(
            p._replace(c_coeffs=cc), spectrum, omega, chunk_size=CHUNK,
            contract='ozaki')
    assert torch.isfinite(infid).all()
    assert got.get('sync.degenerate', 0) == (BATCH // CHUNK if grad else 0)
    assert got['sync.escalation'] == 1


@pytest.mark.parametrize('tol, escalated', [(None, 0), (1e-30, 1)],
                         ids=['default', 'tiny'])
def test_control_matrix_escalation_counts(pulse, monkeypatch, tol,
                                          escalated):
    """calculate_control_matrix_from_scratch on the Ozaki route reads
    each chunk's ratio once and decides once."""
    p, _, omega = pulse
    if tol is not None:
        monkeypatch.setattr(numeric.config, 'ESCALATION_TOL', tol)
    w, v, props = numeric.diagonalize(torch.einsum(
        'jmn,jg->gmn', p.c_opers, p.c_coeffs[0].to(p.c_opers.dtype)),
        p.dt[0])
    with _delta() as got:
        numeric.calculate_control_matrix_from_scratch(
            w, v, props, omega, p.basis, p.n_opers, p.n_coeffs[0], p.dt[0],
            contract='ozaki', budget_bytes=1 << 30)
    want = {'sync.escalation': 1, 'escalation.decisions': 1,
            'escalation.escalated': escalated,
            'ozaki.int8_ops': PULSE_INT8_OPS}
    assert got == {k: v for k, v in want.items() if v}


@pytest.mark.parametrize('calls', [1, 3])
def test_expm_counts(calls):
    a = torch.tensor(np.random.default_rng(0).standard_normal((2, 3, 3)))
    with _delta() as got:
        for _ in range(calls):
            numeric._expm(a)
    assert got == {'sync.expm': calls}


# -----------------------------------------------------------------------------
# The error transfer matrix
# -----------------------------------------------------------------------------
ETM_PARTS = ('ff.prep', 'ff.etm.steps', 'ff.so.shifts', 'ff.etm.cumulant')


def _within(inner, outer):
    return outer[0] <= inner[0] <= inner[1] <= outer[1]


@pytest.mark.parametrize('second_order', [False, True],
                         ids=['first', 'second'])
def test_spans_of_the_error_transfer_matrix(pulse, second_order):
    """One ff.etm per call, and in it, in turn and each once, ff.prep,
    ff.etm.steps, with the second order ff.so.shifts (a diagonal
    spectrum), and ff.etm.cumulant; the matrices bit for bit those
    without a profiler."""
    p, spectrum, omega = pulse

    def fn():
        return functional.batched_error_transfer_matrix(
            p, spectrum, omega, Basis.ggm(D), second_order=second_order)
    off = fn()
    on, events = _profiled(fn)
    assert torch.equal(on, off)
    etm, = _ranges(events, 'ff.etm')
    parts = [name for name in ETM_PARTS
             if second_order or name != 'ff.so.shifts']
    found = []
    for name in parts:
        span, = _ranges(events, name)
        assert _within(span, etm)
        found.append(span)
    for before, after in zip(found, found[1:]):
        assert before[1] <= after[0]
    assert not _ranges(events, 'ff.so.total')
    assert not _ranges(events, 'ff.contract')
    if not second_order:
        assert not _ranges(events, 'ff.so.shifts')


@pytest.mark.parametrize('order, kind, rows', [
    (1, 'diagonal', set()), (2, 'diagonal', {1}), (2, 'cross', set())],
    ids=['first', 'second', 'second_cross'])
def test_shift_counts_of_the_error_transfer_matrix(pulse, monkeypatch,
                                                   order, kind, rows):
    """The second order of a diagonal spectrum builds the shifts' weighted
    K2 lattice with one row of weights for the pulses' one noise
    operator; the first order and a cross-spectrum build none.  Each
    call reads the device once, for the exponential."""
    p, spectrum, omega = pulse
    if kind == 'cross':
        spectrum = spectrum[None, None]
    built = record_lattice_rows(monkeypatch)
    with _delta() as got:
        functional.batched_error_transfer_matrix(
            p, spectrum, omega, Basis.ggm(D), second_order=order == 2)
    assert got == {'sync.expm': 1}
    assert set(built) == rows


def test_cross_spectrum_takes_the_total_span(pulse):
    """A cross-spectrum's second order runs F^(2) in ff.so.total, inside
    ff.etm between ff.etm.steps and ff.etm.cumulant, and no
    ff.so.shifts."""
    p, _, omega = pulse
    spectrum = torch.ones(1, 1, 1) * (1e-3 / omega)
    _, events = _profiled(lambda: functional.batched_error_transfer_matrix(
        p, spectrum, omega, Basis.ggm(D), second_order=True))
    etm, = _ranges(events, 'ff.etm')
    steps, = _ranges(events, 'ff.etm.steps')
    total, = _ranges(events, 'ff.so.total')
    cumulant, = _ranges(events, 'ff.etm.cumulant')
    assert _within(total, etm)
    assert steps[1] <= total[0] and total[1] <= cumulant[0]
    assert not _ranges(events, 'ff.so.shifts')


def test_no_range_without_a_profiler(pulse, monkeypatch):
    """Without a profiler the error transfer matrix opens no range."""
    p, spectrum, omega = pulse
    opened = []

    def record(name):
        opened.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.profiler, 'record_function', record)
    functional.batched_error_transfer_matrix(p, spectrum, omega,
                                             Basis.ggm(D), second_order=True)
    assert opened == []


def test_tables_list_the_spans_and_counters():
    """tracing's docstring tables name exactly the spans the package opens
    and the counters it increments."""
    doc = tracing.__doc__
    spans_doc = doc[doc.index('Span '):doc.index('The backward')]
    counters_doc = doc[doc.index('Counter '):doc.index('The port\'s other')]
    source = ''.join(path.read_text() for path in
                     Path(tracing.__file__).parent.rglob('*.py'))
    assert set(re.findall(r"tracing\.span\('([\w.]+)'\)", source)) == \
        set(re.findall(r'^``([\w.]+)``', spans_doc, re.M))
    assert set(re.findall(r"(?:tracing\.)?counts\['([\w.]+)'\]", source)) \
        == set(re.findall(r'^``([\w.]+)``', counters_doc, re.M))
