"""The ``qft4_etm2_xcorr.jitter4`` cell's files on the CPU: the readers
of its two new per-layer metrics on a synthetic trace, and left out
without the program's spans; the roofline's operation count against a
hand count; the entry's spectrum against the configuration; and runs
of the cell's entry, reference and limits on a small configuration
(the 2-qubit QFT pulse at 32 frequencies, its two single-qubit Z
operators correlated, frozen into new files as
``test_perfbench_etm2.py`` does): the sound program is correct and
holds the reference, a program that drops the spectrum's entries off
the diagonal is not, and the control fails the limits."""
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
SEED = 3000000459
CELL = 'qft4_etm2_xcorr.jitter4'
SMALL = 'qft2_etm2_xcorr.jitter4'
MS = 1_000_000          # ns
NEW = ('so.mix.ms_per_pulse', 'so.xcorr_fp64_roofline')
SHARED = ('prep.idle_ms_per_pulse', 'host.syncs_per_call',
          'etm.steps.ms_per_pulse', 'so.shifts.ms_per_pulse',
          'etm.cumulant.ms_per_pulse', 'etm.idle_ms_per_pulse')


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
    ``ff.spectrum.profiles`` [0.6, 0.9] launching a 0.1-ms copy,
    ``ff.etm.steps`` [1, 2] launching a 1.5-ms kernel and holding
    ``ff.so.mix`` [1.8, 1.9] with a 0.2-ms kernel, ``ff.so.shifts``
    [3, 6] launching kernels of 0.8 and 2.5 ms and holding ``ff.so.mix``
    [3.5, 3.6] with a 0.3-ms kernel."""
    ops = [DeviceOp('memcpy', 'memcpy', ms(0.7), ms(0.8), ms(0.65)),
           DeviceOp('zgemm', 'kernel', ms(1.5), ms(3), ms(1.2)),
           DeviceOp('mix', 'kernel', ms(3), ms(3.2), ms(1.85)),
           DeviceOp('dgemm', 'kernel', ms(3.2), ms(4), ms(3.1)),
           DeviceOp('mix', 'kernel', ms(4), ms(4.3), ms(3.55)),
           DeviceOp('dgemm', 'kernel', ms(4.5), ms(7), ms(5.0))]
    spans = [Interval('call', 0, ms(10)), Interval('etm', ms(0.2), ms(9.8))]
    if program:
        spans += [Interval('ff.etm', ms(0.5), ms(9.5)),
                  Interval('ff.spectrum.profiles', ms(0.6), ms(0.9)),
                  Interval('ff.etm.steps', ms(1), ms(2)),
                  Interval('ff.so.mix', ms(1.8), ms(1.9)),
                  Interval('ff.so.shifts', ms(3), ms(6)),
                  Interval('ff.so.mix', ms(3.5), ms(3.6))]
    return Trace(ops, spans, [])


def test_readers_of_the_spans():
    run_ = Run(synthetic(), 4)
    assert metric('so.mix.ms_per_pulse').read(run_) == \
        pytest.approx((0.1 + 0.2 + 0.3) / 4)
    roofline = metric('so.xcorr_fp64_roofline')
    flops = roofline.pulse_flops(roofline.configuration())
    want = 100 * 4 * flops / 3.6e-3 / 67e12
    assert roofline.read(run_) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize('name', NEW)
def test_left_out_without_the_spans(name):
    assert metric(name).read(Run(synthetic(program=False), 4)) is None
    assert metric(name).read(Run(None, 4)) is None


def test_operations_by_hand():
    """The diagonal spectrum's count at one profile, imported, plus the
    mixing of the four correlated Z operators: per segment a complex
    (4 x 4) product over the complete steps' 256 x 1000 and the
    incomplete steps' 256 x 256 entries, 8 * 16 * 256 * 1256 * 13; at
    the small shape of so.shifts_fp64_roofline's hand count (d = 2,
    one segment, 4 basis elements, one frequency) with two correlated
    operators, 8 * 4 * 4 * (1 + 4)."""
    roofline = metric('so.xcorr_fp64_roofline')
    diagonal = metric('so.shifts_fp64_roofline')
    config = roofline.configuration()
    assert roofline.pulse_flops(config) == \
        122683392000 + 27262976000 + 62813896704 \
        + 8 * 16 * 256 * 1256 * 13
    assert roofline.pulse_flops(config) - 8 * 16 * 256 * 1256 * 13 == \
        diagonal.pulse_flops(**diagonal.shapes(diagonal.configuration()))
    small = dict(config, d=2, n_segments=1, n_nops=2, n_basis=4,
                 omega={'geomspace': [1.0, 1.0, 1]},
                 correlations=dict(config['correlations'],
                                   operators=['a', 'b']))
    assert roofline.pulse_flops(small) == \
        2 * (128 + 1024) + 512 + 8 * 4 * 4 * (1 + 4)


def test_the_cell_reports_its_layers():
    """The new cell reports the shared ETM layers' metrics, the host's
    reads and prep's idle time, and the two new ones; no other cell
    reports the new ones."""
    reported = {m['name'] for m in manifest.cell(ROOT, CELL).per_layer}
    assert set(SHARED) | set(NEW) <= reported
    for name in ('qft4.infidelity', 'qft4.gradient', 'qft4_etm2.jitter4'):
        reported = {m['name'] for m in manifest.cell(ROOT, name).per_layer}
        assert not reported & set(NEW)


def test_the_entrys_spectrum_is_the_configurations():
    """S_ab(w) of the entry, built on the device at set-up, is C_ab 1e-4
    / w with C from the configuration's labels: 1 on the diagonal, and
    0.5^|j - k| between the single-qubit Z operators of qubits j and k
    (IIIZ is qubit 0), found among the QFT pulse's noise operators by
    their identifiers; 18 + 12 entries not zero."""
    cell = manifest.cell(ROOT, CELL)
    data = manifest.inputs(cell.config, ROOT)
    entry = manifest.module(ROOT, 'entries', cell.mix['entry']).Entry(
        data, cell.mix, 'cpu', run.trace.Spans())
    labels = [str(x) for x in qft.qft_pulse(4, device='cpu')
              .n_oper_identifiers]
    corr = cell.config['correlations']
    assert [labels[i] for i in corr['indices']] == corr['operators']
    c = np.eye(18)
    zs = {i: label[::-1].index('Z') for i, label in enumerate(labels)
          if label.count('Z') == 1 and set(label) == {'I', 'Z'}}
    assert sorted(zs) == [2, 5, 9, 14]
    for a, j in zs.items():
        for b, k in zs.items():
            c[a, b] = 0.5 ** abs(j - k)
    omega = np.geomspace(1e-2, 1e2, 1000)
    want = c[:, :, None] * (1e-4 / omega)
    assert torch.equal(entry.spectrum, torch.as_tensor(want))
    assert int((entry.spectrum != 0).any(-1).sum()) == 30


# -----------------------------------------------------------------------------
# Runs of the cell's files on a small configuration
# -----------------------------------------------------------------------------
@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """A checkout with the cell's entry, mix, reference and limits on the
    2-qubit QFT pulse (d = 4, 7 segments, 7 noise operators, 16-element
    basis, 32 frequencies; IZ and ZI correlated by 0.5), as new files
    and manifest entries."""
    tmp = tmp_path_factory.mktemp('checkout')
    shutil.copytree(ROOT / 'perfbench', tmp / 'perfbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__',
                                                  'tests'))
    pb = tmp / 'perfbench'
    np.savez(pb / 'data' / 'qft2_arrays.npz', **qft._load(2))
    config = json.loads((pb / 'configs' / 'qft4_etm2_xcorr.json')
                        .read_text())
    config.update(name='qft2_etm2_xcorr', n_qubits=2, d=4, n_segments=7,
                  n_ctrl=7, n_nops=7, n_basis=16,
                  arrays='perfbench/data/qft2_arrays.npz',
                  omega={'geomspace': [0.01, 100.0, 32]},
                  correlations=dict(config['correlations'],
                                    operators=['IZ', 'ZI'], indices=[2, 5],
                                    positions=[0, 1]))
    (pb / 'configs' / 'qft2_etm2_xcorr.json').write_text(json.dumps(config))
    (pb / 'reference' / 'qft2_etm2_xcorr.py').write_text(
        'from perfbench.reference.qft4_etm2_xcorr import Reference  '
        '# noqa: F401\n')
    shutil.copy(pb / 'limits' / f'{CELL}.json',
                pb / 'limits' / f'{SMALL}.json')
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'qft2_etm2_xcorr', 'source': 'test',
                             'file': 'perfbench/configs/qft2_etm2_xcorr.json',
                             'reduced': [], 'why': 'test'})
    bench['workloads'].append({'name': SMALL, 'config': 'qft2_etm2_xcorr',
                               'traffic': 'etm2x_jitter4', 'chips': 1,
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


def _uncorrelated(fn):
    """The spectrum's entries off the diagonal zeroed before the
    profiles: the correlations dropped."""
    def broken(spectrum, omega, n, given=None):
        eye = torch.eye(n, dtype=torch.bool, device=spectrum.device)
        return fn(torch.where(eye[:, :, None], spectrum, 0), omega, n)
    return broken


def test_a_program_without_correlations_is_not_correct(root, capsys,
                                                       monkeypatch):
    monkeypatch.setattr(numeric, '_spectrum_profiles',
                        _uncorrelated(numeric._spectrum_profiles))
    assert result(root, capsys)['correct'] is False


def _sampled(root):
    cell = manifest.cell(root, SMALL)
    device = torch.device('cpu')
    entry, data, spans = run.set_up(cell, root, device, SEED, False)
    win = run.window(entry, cell, device, SEED, 0.2, spans)
    reference = manifest.module(root, 'reference',
                                cell.workload['config']).Reference(data,
                                                                   device)
    picked = check.sample_calls([c.size for c, _ in win.done],
                                int(cell.mix['check_calls']), SEED)
    return cell, entry, reference, [win.done[i] for i in picked]


def test_the_control_fails_the_limits(root):
    """The reference in float32 in the program's place reads above both
    limits; the reference without the correlations reads above both by
    far more than 100 times."""
    cell, entry, reference, done = _sampled(root)
    limits = cell.limits['numbers']
    control = entry.compare(entry.control(done, reference), reference)
    assert all(control[k] > limits[k] for k in limits), control
    reference.cross = reference.cross * torch.eye(
        reference.cross.shape[0], dtype=reference.cross.dtype)[:, :, None]
    dropped = [(c, (reference.error_transfer_matrices(c.inputs),))
               for c, _ in done]
    _, _, sound, _ = _sampled(root)
    numbers = entry.compare(dropped, sound)
    assert all(numbers[k] > 100 * limits[k] for k in limits), numbers


def test_the_reference_holds_the_port(root):
    """The reference's matrices of a sampled call against the port's
    functional path on the same inputs within 1e-12 of each row's
    largest entry of E - I."""
    _, entry, reference, done = _sampled(root)
    call, (got,) = done[0]
    want = reference.error_transfer_matrices(call.inputs)
    eye = torch.eye(want.shape[-1], dtype=want.dtype)
    assert check.rel_gap(got - eye, want - eye) < 1e-12


def test_the_entry_is_the_functional_path(root):
    """One call of the entry is the port's second-order batched error
    transfer matrix of the jittered rows under the cross-spectrum, bit
    for bit.  The first call reads the device twice, the spectrum's
    profiles (which its tensor keeps) and the exponential; each later
    call once, for the exponential, which ``host.syncs_per_call``
    reads."""
    from perfbench.metrics import _program
    cell = manifest.cell(root, SMALL)
    data = manifest.inputs(cell.config, root)
    entry = manifest.module(root, 'entries', cell.mix['entry']).Entry(
        data, cell.mix, 'cpu', run.trace.Spans())
    assert entry.spectrum.shape == (7, 7, 32)
    calls = run.traffic.calls(cell.mix, cell.config, SEED)
    reads = []
    for _ in range(3):
        call = next(calls)
        state = Run(None, 0)
        close = _program.instrument(state)
        got, = entry.call(call)
        close()
        reads.append({k: v for k, v in state.counters[_program.COUNTS]
                      .items() if k.startswith('sync.') and v})
    assert reads == [{'sync.spectrum': 1, 'sync.expm': 1}] \
        + [{'sync.expm': 1}] * 2
    p = entry.pulse._replace(c_coeffs=entry.pulse.c_coeffs[None]
                             * torch.as_tensor(call.inputs['scales']))
    want = functional.batched_error_transfer_matrix(
        p, entry.spectrum, entry.omega, entry.basis, second_order=True)
    assert torch.equal(got, want)
    assert got.shape == entry.shape(call) == (4, 16, 16)
