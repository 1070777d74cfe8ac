"""The port's spans and counters (filter_functions_tpu_torch.tracing):
the spans appear, nested as documented, only under a profiler and
change no value; the counters count each read of the device and each
escalation decision at its site, and the int8 operations of the Ozaki
slice products."""
import contextlib
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from filter_functions_tpu_torch import functional, numeric, tracing, util
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


@pytest.mark.parametrize('profiled', [False, True],
                         ids=['no_profiler', 'no_grad'])
def test_backward_span_is_inert_without_a_profiler_or_grad(profiled):
    """Without a profiler, or under one with grad disabled, a backward
    span hands back its inputs and outputs themselves."""
    x = torch.ones(3, requires_grad=True)

    def fn():
        with torch.no_grad() if profiled else contextlib.nullcontext():
            region = tracing.backward_span('ff.test.backward', x, None)
            assert region.inputs[0] is x and region.inputs[1] is None
            y = region.inputs[0] * 2
            assert region.outputs(y) is y
            assert region.outputs(y, x) == (y, x)
    if profiled:
        _profiled(fn)
    else:
        fn()


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


@pytest.mark.parametrize('budget_bytes', [None, 1], ids=['one', 'each'])
def test_tables_span_once_a_chunk(pulse, budget_bytes):
    """ff.so.tables opens once a chunk of the shifts' segments, each
    inside ff.so.shifts and after the one before: one chunk in the
    default budget, a chunk a segment in a budget of one byte.  Beside
    them in ff.so.shifts, first ff.so.steps once (the complete steps),
    then ff.so.sandwich once for the noise-basis products and once
    after each chunk's tables; none overlaps another."""
    p, spectrum, omega = pulse
    eigvals, (_, n_t, b_t, ph, integral), _ = functional._prep(
        p, p.c_coeffs, p.n_coeffs, p.dt, omega)
    step = numeric._ctrlmat_step_contract(n_t, integral, b_t, ph)
    weights = numeric._spectral_weights(spectrum, omega, 1)
    _, events = _profiled(lambda: numeric._second_order_diag_shifts(
        eigvals, n_t, b_t, step, omega, p.dt, weights, budget_bytes))
    shifts, = _ranges(events, 'ff.so.shifts')
    tables = _ranges(events, 'ff.so.tables')
    assert len(tables) == (1 if budget_bytes is None else G)
    assert all(_within(t, shifts) for t in tables)
    assert all(a[1] <= b[0] for a, b in zip(tables, tables[1:]))
    steps = _ranges(events, 'ff.so.steps')
    sandwich = _ranges(events, 'ff.so.sandwich')
    assert len(steps) == 1 and len(sandwich) == len(tables) + 1
    parts = sorted(steps + sandwich + tables)
    assert all(_within(s, shifts) for s in parts)
    assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))
    assert parts[0] == steps[0] and parts[1] == sandwich[0]
    assert parts[2::2] == tables and parts[3::2] == sandwich[1:]


#: The program's ranges of the second-order ETM's backward: the whole,
#: and the stages that tracing.backward_span marks
ETM_BACKWARD = 'ff.etm.backward'
BACKWARD_STAGES = ('ff.etm.cumulant.backward', 'ff.so.sandwich.backward',
                   'ff.etm.steps.backward', 'ff.prep.backward')
MARKERS = ('_OpenBackward', '_CloseBackward')


def _node_types(t) -> Counter:
    """The autograd nodes of *t*'s graph, counted by type."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and node not in seen:
            seen.add(node)
            stack.extend(n for n, _ in node.next_functions)
    return Counter(type(n).__name__ for n in seen)


def _nested_or_apart(ranges) -> bool:
    return all(a[1] <= b[0] or b[1] <= a[0] or _within(a, b)
               or _within(b, a)
               for i, a in enumerate(ranges) for b in ranges[i + 1:])


@pytest.mark.parametrize('degenerate', [False, True],
                         ids=['distinct', 'degenerate'])
def test_spans_of_the_second_order_backward(pulse, degenerate):
    """Autograd of the second-order ETM opens ff.so.degenerate.backward
    once, after the forward's ff.etm, where a segment is degenerate, and
    none where none is; on the CPU the forward takes the plain tables
    under autograd, so no ff.so.tables.backward opens.  The backward
    spans open ff.etm.backward once, after the forward's ff.etm, and in
    it each stage's range at least once; no two of these ranges and the
    Functions' own overlap but by nesting.  Without a profiler the
    graph holds no marker and otherwise the nodes it holds under one;
    the gradient is bit for bit the same, and no counter but the reads
    of the device moves."""
    p, spectrum, omega = pulse
    cc = p.c_coeffs.clone()
    if degenerate:
        cc[..., :5] = 0           # H = 0: one eigenspace of dimension d

    def fn():
        c = cc.clone().requires_grad_(True)
        etm = functional.batched_error_transfer_matrix(
            p._replace(c_coeffs=c), spectrum, omega, Basis.ggm(D),
            second_order=True)
        return etm, torch.autograd.grad(etm.sum(), c)[0]
    etm_off, off = fn()
    with _delta() as got:
        (etm_on, on), events = _profiled(fn)
    assert torch.equal(on, off)
    types_off, types_on = _node_types(etm_off), _node_types(etm_on)
    assert not any(types_off[m] for m in MARKERS)
    assert all(types_on[m] for m in MARKERS)
    assert types_on - Counter({m: types_on[m] for m in MARKERS}) \
        == types_off
    assert got == {'sync.expm': 1, 'sync.degenerate': 2}
    etm, = _ranges(events, 'ff.etm')
    spans = _ranges(events, 'ff.so.degenerate.backward')
    assert len(spans) == degenerate
    assert all(etm[1] <= s[0] for s in spans)
    assert not _ranges(events, 'ff.so.tables.backward')
    whole, = _ranges(events, ETM_BACKWARD)
    assert etm[1] <= whole[0]
    ranges = spans + _ranges(events, 'ff.so.steps.backward')
    for name in BACKWARD_STAGES:
        found = _ranges(events, name)
        assert found, name
        ranges += found
    assert all(_within(r, whole) for r in ranges)
    assert _nested_or_apart(ranges)


@pytest.mark.parametrize('budget_bytes, sub_chunks', [(None, 1), (1, 3)],
                         ids=['one', 'each'])
def test_tables_backward_spans_and_count(budget_bytes, sub_chunks):
    """The tables' autograd Function rebuilds them in its backward in
    span ff.so.tables.backward, once a sub-chunk, one after the other:
    all 3 segments at once in the default budget, one a sub-chunk in a
    budget of one byte; each way the gradient is bit for bit that
    without a profiler, and no counter moves."""
    rng = np.random.default_rng(29)
    omega = torch.tensor(np.geomspace(0.3, 6, 7))
    eigvals = torch.tensor(np.sort(rng.standard_normal((2, 3, D)), -1),
                           requires_grad=True)
    dt = torch.tensor(rng.random((2, 3)) + 0.5)
    weights = torch.tensor(rng.random((1, 7)))

    def fn():
        out = numeric._K2Tables.apply(omega, eigvals, dt, weights,
                                      budget_bytes)
        return torch.autograd.grad(out.abs().sum(), eigvals)[0]
    off = fn()
    with _delta() as got:
        on, events = _profiled(fn)
    assert got == {}
    assert torch.equal(on, off)
    spans = _ranges(events, 'ff.so.tables.backward')
    assert len(spans) == sub_chunks
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize('grad', [False, True], ids=['forward', 'backward'])
def test_steps_backward_span_and_count(pulse, grad):
    """Autograd of the second-order ETM opens ff.so.steps.backward once,
    after the forward's ff.etm, inside ff.etm.backward, with the
    gradient bit for bit that without a profiler; the forward alone
    opens no such range.  No counter moves but the reads of the
    device."""
    p, spectrum, omega = pulse

    def fn():
        c = p.c_coeffs.clone().requires_grad_(grad)
        etm = functional.batched_error_transfer_matrix(
            p._replace(c_coeffs=c), spectrum, omega, Basis.ggm(D),
            second_order=True)
        if grad:
            return torch.autograd.grad(etm.sum(), c)[0]
    with _delta() as got:
        on, events = _profiled(fn)
    spans = _ranges(events, 'ff.so.steps.backward')
    if not grad:
        assert not spans and not _ranges(events, ETM_BACKWARD)
        assert got == {'sync.expm': 1}
        return
    assert got == {'sync.expm': 1, 'sync.degenerate': 2}
    etm, = _ranges(events, 'ff.etm')
    whole, = _ranges(events, ETM_BACKWARD)
    span, = spans
    assert etm[1] <= span[0] and _within(span, whole)
    assert torch.equal(on, fn())


@pytest.mark.parametrize('order, kind, rows', [
    (1, 'diagonal', set()), (2, 'diagonal', {1}), (2, 'cross', {1})],
    ids=['first', 'second', 'second_cross'])
def test_shift_counts_of_the_error_transfer_matrix(pulse, monkeypatch,
                                                   order, kind, rows):
    """The second order builds the shifts' weighted K2 lattice with one
    row of weights for the pulses' one noise operator, of a diagonal
    spectrum and of the same given as a (1, 1, n_w) cross-spectrum (one
    profile); the first order builds none.  Each call reads the device
    once for the exponential, and a cross-spectrum once more, for its
    profiles and its Hermitian check (``sync.spectrum``)."""
    p, spectrum, omega = pulse
    reads = {'sync.expm': 1}
    if kind == 'cross':
        spectrum = spectrum[None, None]
        reads['sync.spectrum'] = 1
    built = record_lattice_rows(monkeypatch)
    with _delta() as got:
        functional.batched_error_transfer_matrix(
            p, spectrum, omega, Basis.ggm(D), second_order=order == 2)
    assert got == reads
    assert set(built) == rows


def _correlated(pulse):
    """The pulses of the fixture with a second noise operator, and a
    Hermitian cross-spectrum of the two: S_ab = C_ab 1e-3 / omega with
    C_01 = 0.4 + 0.3i, one profile."""
    p, _, omega = pulse
    rng = np.random.default_rng(23)
    n_coeffs = torch.tensor(rng.random((BATCH, 1, G)))
    p = p._replace(n_opers=torch.cat([p.n_opers, torch.tensor(_herm(1, rng))]),
                   n_coeffs=torch.cat([p.n_coeffs, n_coeffs], 1))
    c = torch.tensor([[1.0, 0.4 + 0.3j], [0.4 - 0.3j, 0.5]])
    return p, c[:, :, None] * (1e-3 / omega), omega


def test_cross_spectrum_takes_the_total_span(pulse):
    """A cross-spectrum's second order runs in ff.so.shifts like a
    diagonal one's, not in F^(2)'s ff.so.total: inside ff.etm,
    ff.spectrum.profiles comes first, before ff.prep; ff.so.mix opens
    once in ff.etm.steps (the decay amplitudes) and in ff.so.shifts once
    for each of the G - 1 updates of the running sum and each chunk of
    the incomplete steps, and nowhere else.  The matrices are bit for bit
    those without a profiler, and the call reads the device twice, once
    for the spectrum and once for the exponential."""
    p, spectrum, omega = _correlated(pulse)

    def fn():
        return functional.batched_error_transfer_matrix(
            p, spectrum, omega, Basis.ggm(D), second_order=True)
    with _delta() as got:
        off = fn()
    assert got == {'sync.spectrum': 1, 'sync.expm': 1}
    on, events = _profiled(fn)
    assert torch.equal(on, off)
    etm, = _ranges(events, 'ff.etm')
    profiles, = _ranges(events, 'ff.spectrum.profiles')
    prep, = _ranges(events, 'ff.prep')
    steps, = _ranges(events, 'ff.etm.steps')
    shifts, = _ranges(events, 'ff.so.shifts')
    assert _within(profiles, etm) and profiles[1] <= prep[0]
    mixes = _ranges(events, 'ff.so.mix')
    in_steps = [m for m in mixes if _within(m, steps)]
    in_shifts = [m for m in mixes if _within(m, shifts)]
    eigvals = torch.zeros(BATCH, G, D)
    chunks = -(-G // numeric._shifts_chunk(eigvals, len(omega), 1,
                                           mixed=3 * 2 * D ** 4))
    assert len(in_steps) == 1 and len(in_shifts) == G - 1 + chunks
    assert len(mixes) == len(in_steps) + len(in_shifts)
    assert not _ranges(events, 'ff.so.total')


def test_a_spectrum_tensor_keeps_its_profiles(pulse):
    """The profiles of a cross-spectrum given as a tensor are read once
    and kept by the tensor: a second call reads the device only for the
    exponential, and gives the first call's matrices bit for bit; a
    write in place (its version counter) makes the next call read the
    spectrum again and follow the new values; a numpy spectrum is read
    on every call."""
    p, spectrum, omega = _correlated(pulse)

    def fn(s):
        return functional.batched_error_transfer_matrix(
            p, s, omega, Basis.ggm(D), second_order=True)
    reads = []
    for _ in range(2):
        with _delta() as got:
            out = fn(spectrum)
        reads.append(got)
    assert reads == [{'sync.spectrum': 1, 'sync.expm': 1}, {'sync.expm': 1}]
    assert torch.equal(out, fn(spectrum.clone()))
    spectrum[0, 1] *= 2
    spectrum[1, 0] *= 2
    with _delta() as got:
        changed = fn(spectrum)
    assert got == {'sync.spectrum': 1, 'sync.expm': 1}
    assert torch.equal(changed, fn(spectrum.clone()))
    assert not torch.equal(changed, out)
    for _ in range(2):
        with _delta() as got:
            fn(spectrum.numpy())
        assert got == {'sync.spectrum': 1, 'sync.expm': 1}


def test_parse_spectrum_counts_its_hermitian_check(pulse):
    """util.parse_spectrum reads the device to check that a 3-d spectrum
    is Hermitian, once a call, counted as ``sync.spectrum``; a 1-d or
    2-d spectrum needs no read."""
    _, spectrum, omega = _correlated(pulse)
    idx = np.arange(2)
    with _delta() as got:
        util.parse_spectrum(spectrum, omega, idx)
        util.parse_spectrum(spectrum[0, 0], omega, idx)
        util.parse_spectrum(spectrum[0].real, omega, idx)
    assert got == {'sync.spectrum': 1}


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
    """tracing's docstring tables name exactly the spans the package opens,
    through :func:`tracing.span` and :func:`tracing.backward_span`, and the
    counters it increments."""
    doc = tracing.__doc__
    spans_doc = doc[doc.index('Span '):doc.index('The backward')]
    counters_doc = doc[doc.index('Counter '):doc.index('The port\'s other')]
    source = ''.join(path.read_text() for path in
                     Path(tracing.__file__).parent.rglob('*.py'))
    opened = set(re.findall(r"tracing\.span\('([\w.]+)'\)", source)) | \
        set(re.findall(r"tracing\.backward_span\(\s*'([\w.]+)'", source))
    assert opened == set(re.findall(r'^``([\w.]+)``', spans_doc, re.M))
    assert set(re.findall(r"(?:tracing\.)?counts\['([\w.]+)'\]", source)) \
        == set(re.findall(r'^``([\w.]+)``', counters_doc, re.M))
