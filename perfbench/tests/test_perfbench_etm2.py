"""The ``qft4_etm2.jitter4`` cell's files on the CPU: the readers of its
five per-layer metrics on a synthetic trace, and left out without the
program's spans; the roofline's operation count against a hand count;
the reference's K2 lattice against the closed form with its limits;
and runs of the cell's entry, reference and limits on a small
configuration (the 2-qubit QFT pulse at 32 frequencies, frozen into new
files as ``test_perfbench_harness.py`` does): the sound program is
correct, a program with a fault planted under the timed path is not,
and the control fails the limits."""
import cmath
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from filter_functions_tpu_torch import functional, numeric
from filter_functions_tpu_torch.models import qft
from perfbench import run
from perfbench.lib import check, manifest
from perfbench.lib.trace import DeviceOp, Interval, Trace

ROOT = Path(__file__).resolve().parents[2]
SEED = 3000000457
CELL = 'qft4_etm2.jitter4'
SMALL = 'qft2_etm2.jitter4'
MS = 1_000_000          # ns
METRICS = ('etm.steps.ms_per_pulse', 'so.shifts.ms_per_pulse',
           'etm.cumulant.ms_per_pulse', 'etm.idle_ms_per_pulse',
           'so.shifts_fp64_roofline')


class Run:
    def __init__(self, trace, pulses):
        self.trace, self.pulses = trace, pulses
        self.counters = {}


def metric(name):
    return manifest.module(ROOT, 'metrics', name)


def ms(x: float) -> int:
    return int(round(x * MS))


def synthetic(program: bool = True) -> Trace:
    """One call over [0, 10] ms with ``ff.etm`` over [0.5, 9.5] and in it
    ``ff.etm.steps`` [1, 2] launching a 1.5-ms kernel at [1.5, 3],
    ``ff.so.shifts`` [3, 6] launching kernels at [3.2, 4] and [4.5, 7]
    (gap [4, 4.5]), ``ff.etm.cumulant`` [7, 9] launching [7.5, 8] (gap
    [7, 7.5]); idle in ``ff.etm``: [0.5, 1.5], [3, 3.2], [4, 4.5],
    [7, 7.5], [8, 9.5]."""
    ops = [DeviceOp('zgemm', 'kernel', ms(1.5), ms(3), ms(1.2)),
           DeviceOp('dgemm', 'kernel', ms(3.2), ms(4), ms(3.1)),
           DeviceOp('dgemm', 'kernel', ms(4.5), ms(7), ms(5.0)),
           DeviceOp('zgemm', 'kernel', ms(7.5), ms(8), ms(7.2))]
    spans = [Interval('call', 0, ms(10)), Interval('etm', ms(0.2), ms(9.8))]
    if program:
        spans += [Interval('ff.etm', ms(0.5), ms(9.5)),
                  Interval('ff.etm.steps', ms(1), ms(2)),
                  Interval('ff.so.shifts', ms(3), ms(6)),
                  Interval('ff.etm.cumulant', ms(7), ms(9))]
    return Trace(ops, spans, [])


def test_readers_of_the_spans():
    run_ = Run(synthetic(), 4)
    assert metric('etm.steps.ms_per_pulse').read(run_) == \
        pytest.approx(1.5 / 4)
    assert metric('so.shifts.ms_per_pulse').read(run_) == \
        pytest.approx(3.3 / 4)
    assert metric('etm.cumulant.ms_per_pulse').read(run_) == \
        pytest.approx(0.5 / 4)
    assert metric('etm.idle_ms_per_pulse').read(run_) == \
        pytest.approx(3.7 / 4)
    roofline = metric('so.shifts_fp64_roofline')
    want = 100 * 4 * 2.1275e11 / 3.3e-3 / 67e12
    assert roofline.read(run_) == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize('name', METRICS)
def test_left_out_without_the_spans(name):
    assert metric(name).read(Run(synthetic(program=False), 4)) is None
    assert metric(name).read(Run(None, 4)) is None


def test_operations_by_hand_at_a_small_shape():
    """d = 2, one segment, one noise operator, 4 basis elements, one
    frequency: the complete steps 1 x 4 x 4 complex multiply-adds (128
    operations); the tables' two real (4 x 8) @ (8 x 4) products (512);
    the sandwich's (4 x 4) @ (4 x 4) and (4 x 4) @ (4 x 4) complex
    products (1024).  With two noise operators the complete steps and
    the sandwich double; the tables double only where the two have
    spectra of their own."""
    roofline = metric('so.shifts_fp64_roofline')
    assert roofline.pulse_flops(2, 1, 1, 4, 1, 1) == 128 + 512 + 1024
    assert roofline.pulse_flops(2, 1, 2, 4, 1, 1) == 2 * (128 + 1024) + 512
    assert roofline.pulse_flops(2, 1, 2, 4, 1, 2) == 2 * (128 + 512 + 1024)
    # one flagship pulse: complete steps, the tables of the one shared
    # spectrum row, the sandwich
    assert 8 * 18 * 256 ** 2 * 13 * 1000 == 122683392000
    assert 2 * 2 * 256 ** 2 * 8 * 1000 * 1 * 13 == 27262976000
    assert 8 * 18 * 13 * (256 ** 2 * 256 + 256 ** 2 * 256) == 62813896704
    assert roofline.pulse_flops(**roofline.shapes(roofline.configuration())) \
        == 122683392000 + 27262976000 + 62813896704


def test_shapes_are_the_configurations():
    config = json.loads((ROOT / 'perfbench' / 'configs' / 'qft4_etm2.json')
                        .read_text())
    roofline = metric('so.shifts_fp64_roofline')
    assert roofline.configuration() == config
    assert roofline.shapes(config) == {
        'd': config['d'], 'n_segments': config['n_segments'],
        'n_nops': config['n_nops'], 'n_basis': config['n_basis'],
        'n_omega': config['omega']['geomspace'][2], 'n_spectra': 1}
    # one S(w) for every noise operator: one row of tables; an amplitude
    # per operator: a row each
    per_operator = dict(config, spectrum={'amplitude': [1e-4] * 18,
                                          'power': 1})
    assert roofline.spectrum_rows(per_operator) == 18


def test_only_the_new_cell_reports_them():
    for name in ('qft4.infidelity', 'qft4.gradient'):
        reported = {m['name'] for m in manifest.cell(ROOT, name).per_layer}
        assert not reported & set(METRICS)
    reported = {m['name'] for m in manifest.cell(ROOT, CELL).per_layer}
    assert set(METRICS) <= reported


def test_the_cell_reports_the_shared_layers():
    """The cell's call reads the device (``_expm``) and runs ``ff.prep``:
    it reports the host's reads and prep's idle time, as the ``qft4``
    cells do, and none of the contraction's metrics, whose path it
    bypasses."""
    reported = {m['name'] for m in manifest.cell(ROOT, CELL).per_layer}
    assert {'host.syncs_per_call', 'prep.idle_ms_per_pulse'} <= reported
    assert not reported & {'contraction.idle_ms_per_pulse',
                           'ozaki.products.ms_per_pulse', 'escalation.share',
                           'int8_products_roofline', 'dword_digits_roofline'}


# -----------------------------------------------------------------------------
# Runs of the cell's files on a small configuration
# -----------------------------------------------------------------------------
@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """A checkout with the cell's entry, mix, reference and limits on the
    2-qubit QFT pulse (d = 4, 7 segments, 16-element basis, 32
    frequencies), as new files and manifest entries."""
    tmp = tmp_path_factory.mktemp('checkout')
    shutil.copytree(ROOT / 'perfbench', tmp / 'perfbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__',
                                                  'tests'))
    pb = tmp / 'perfbench'
    np.savez(pb / 'data' / 'qft2_arrays.npz', **qft._load(2))
    config = json.loads((pb / 'configs' / 'qft4_etm2.json').read_text())
    config.update(name='qft2_etm2', n_qubits=2, d=4, n_segments=7,
                  n_basis=16, arrays='perfbench/data/qft2_arrays.npz',
                  omega={'geomspace': [0.01, 100.0, 32]})
    (pb / 'configs' / 'qft2_etm2.json').write_text(json.dumps(config))
    (pb / 'reference' / 'qft2_etm2.py').write_text(
        'from perfbench.reference.qft4_etm2 import Reference  # noqa: F401\n')
    shutil.copy(pb / 'limits' / f'{CELL}.json', pb / 'limits' / f'{SMALL}.json')
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'qft2_etm2', 'source': 'test',
                             'file': 'perfbench/configs/qft2_etm2.json',
                             'reduced': [], 'why': 'test'})
    bench['workloads'].append({'name': SMALL, 'config': 'qft2_etm2',
                               'traffic': 'etm2_jitter4', 'chips': 1,
                               'why': 'test'})
    (tmp / 'BENCHMARK.json').write_text(json.dumps(bench))
    return tmp


def result(root, capsys):
    rc = run.main(['--workload', SMALL, '--seed', str(SEED), '--seconds',
                   '0.3', '--trace', '0'], root=root, device='cpu')
    out = capsys.readouterr().out
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def test_the_sound_program_is_correct(root, capsys):
    out = result(root, capsys)
    assert out['correct'] is True, out['checks']
    assert set(out['checks']) == {'failed_calls', 'etm_rel_gap',
                                  'coherent_rel_gap'}


def _no_shifts(fn):
    """The frequency shifts dropped: the first-order matrices."""
    def broken(*args, **kwargs):
        return torch.zeros_like(fn(*args, **kwargs))
    return broken


def _single_expm(fn):
    """The matrix exponential taken in float32."""
    def broken(a):
        return fn(a.float()).double()
    return broken


FAULTS = [('_second_order_diag_shifts', _no_shifts),
          ('_expm', _single_expm)]


@pytest.mark.parametrize('name,fault', FAULTS, ids=[n for n, _ in FAULTS])
def test_a_planted_fault_is_not_correct(root, capsys, monkeypatch, name,
                                        fault):
    monkeypatch.setattr(numeric, name, fault(getattr(numeric, name)))
    assert result(root, capsys)['correct'] is False


def test_the_control_fails_the_limits(root):
    """The reference in float32 in the program's place, on the window's
    sampled calls, reads above both limits; the reference's first-order
    matrices read above the coherent limit by far more than 10 times."""
    cell = manifest.cell(root, SMALL)
    device = torch.device('cpu')
    entry, data, spans = run.set_up(cell, root, device, SEED, False)
    win = run.window(entry, cell, device, SEED, 0.2, spans)
    reference = manifest.module(root, 'reference',
                                cell.workload['config']).Reference(data,
                                                                   device)
    picked = check.sample_calls([c.size for c, _ in win.done],
                                int(cell.mix['check_calls']), SEED)
    done = [win.done[i] for i in picked]
    limits = cell.limits['numbers']
    control = entry.compare(entry.control(done, reference), reference)
    assert all(control[k] > limits[k] for k in limits), control
    first = [(c, (reference.error_transfer_matrices(c.inputs,
                                                    second_order=False),))
             for c, _ in done]
    numbers = entry.compare(first, reference)
    assert numbers['coherent_rel_gap'] > 10 * limits['coherent_rel_gap']


def test_the_entry_is_the_functional_path(root):
    """One call of the entry is the port's second-order batched error
    transfer matrix of the jittered rows, bit for bit."""
    cell = manifest.cell(root, SMALL)
    data = manifest.inputs(cell.config, root)
    entry = manifest.module(root, 'entries', cell.mix['entry']).Entry(
        data, cell.mix, 'cpu', run.trace.Spans())
    call = next(run.traffic.calls(cell.mix, cell.config, SEED))
    got, = entry.call(call)
    p = entry.pulse._replace(c_coeffs=entry.pulse.c_coeffs[None]
                             * torch.as_tensor(call.inputs['scales']))
    want = functional.batched_error_transfer_matrix(
        p, entry.spectrum, entry.omega, entry.basis, second_order=True)
    assert torch.equal(got, want)
    assert got.shape == entry.shape(call) == (4, 16, 16)


def test_one_read_of_the_device_a_call(root):
    """Each call of the entry counts one read of the device, ``_expm``'s
    (``sync.expm``), which ``host.syncs_per_call`` reads."""
    from perfbench.metrics import _program
    cell = manifest.cell(root, SMALL)
    data = manifest.inputs(cell.config, root)
    entry = manifest.module(root, 'entries', cell.mix['entry']).Entry(
        data, cell.mix, 'cpu', run.trace.Spans())
    calls = run.traffic.calls(cell.mix, cell.config, SEED)
    state = Run(None, 0)
    close = _program.instrument(state)
    for _ in range(3):
        entry.call(next(calls))
    close()
    syncs = {k: v for k, v in state.counters[_program.COUNTS].items()
             if k.startswith('sync.') and v}
    assert syncs == {'sync.expm': 3}


def _closed_form(x: float, y: float, dt: float) -> complex:
    """The published closed form of the K2 lattice with its limits:
    (f(x) - f(x + y)) / y, f(u) = (e^{i u dt} - 1) / u, f(0) = i dt; at
    y = 0, (f(x) - i dt e^{i x dt}) / x; at x = y = 0, dt^2 / 2."""
    def f(u):
        return (cmath.exp(1j * u * dt) - 1) / u if u else 1j * dt
    if y:
        return (f(x) - f(x + y)) / y
    if x:
        return (f(x) - 1j * dt * cmath.exp(1j * x * dt)) / x
    return dt * dt / 2


def test_k2_lattice_against_the_closed_form():
    """The reference's lattice by quadrature against the closed form at
    eigenvalues with a degenerate pair, where y, x and x + y meet zero
    exactly (quarters: every difference exact) or stay away from it
    (|y dt| >= 0.1, where the closed form does not cancel)."""
    from perfbench.reference import second_order
    energies = [-1.5, -0.25, -0.25, 0.5, 1.75]
    omega = [0.01, 0.75, 1.25, 2.0, 37.5, 100.0]
    dt = 1.3
    lattice = second_order.k2_lattice(
        torch.tensor(energies, dtype=torch.float64), dt,
        torch.tensor(omega, dtype=torch.float64)).reshape(
        len(omega), 5, 5, 5, 5)
    checked = zeros = 0
    for o, w in enumerate(omega):
        for i, j, m, n in np.ndindex(5, 5, 5, 5):
            x = energies[i] - energies[j] - w
            y = w + energies[m] - energies[n]
            if y and abs(y * dt) < 0.1:
                continue
            want = _closed_form(x, y, dt)
            assert abs(complex(lattice[o, i, j, m, n]) - want) < 1e-13, \
                (w, i, j, m, n)
            checked += 1
            zeros += y == 0
    assert checked > 3000 and zeros >= 50
