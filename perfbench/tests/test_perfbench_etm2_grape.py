"""The ``qft4_etm2_grape.step4`` cell's files on the CPU: the readers of
its three per-layer metrics on a synthetic trace, and left out without
the spans they read; the configuration against ``qft4_etm2``'s; and
runs of the cell's entry, reference and limits on a small configuration
(the 2-qubit QFT pulse at 16 frequencies, frozen into new files as
``test_perfbench_etm2_xcorr.py`` does): the sound program is correct,
programs with planted faults (the frequency shifts detached from the
graph; the degenerate-eigenspace terms of the derivative dropped) are
not, the control fails the limits, and the entry is the functional path
and its autograd.

The harness runs in a subprocess of its own, with the fault planted
there: a run refuses to report once JAX is imported, which another test
file in the same worker may have done."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from filter_functions_tpu_torch import functional
from filter_functions_tpu_torch.models import qft
from perfbench import run
from perfbench.lib import check, manifest
from perfbench.lib.trace import DeviceOp, Interval, Trace

ROOT = Path(__file__).resolve().parents[2]
SEED = 3000000459
CELL = 'qft4_etm2_grape.step4'
SMALL = 'qft2_etm2_grape.step4'
MS = 1_000_000          # ns
NEW = ('etm.backward.ms_per_pulse', 'so.tables.backward.ms_per_pulse',
       'so.degenerate.backward.ms_per_pulse')
#: One run of the harness on the CPU in a fresh interpreter:
#: argv = checkout, fault, the run's arguments.
RUNNER = """
import sys
root, fault = sys.argv[1:3]
sys.path[:0] = [root, {program!r}]
from filter_functions_tpu_torch import numeric
if fault == 'detached':
    shifts = numeric._second_order_diag_shifts
    numeric._second_order_diag_shifts = \\
        lambda *a, **k: shifts(*a, **k).detach()
elif fault == 'no_degenerate':
    numeric._degenerate_control_matrix = lambda *a, **k: None
    numeric._degenerate_incomplete_steps = lambda *a, **k: None
from perfbench import run
sys.exit(run.main(sys.argv[3:], root=root, device='cpu'))
""".format(program=str(ROOT))


class Run:
    def __init__(self, trace, pulses):
        self.trace, self.pulses = trace, pulses
        self.counters = {}


def metric(name):
    return manifest.module(ROOT, 'metrics', name)


def ms(x: float) -> int:
    return int(round(x * MS))


def synthetic(program: bool = True) -> Trace:
    """One call over [0, 10] ms: ``forward`` [0.2, 3] launching a 2-ms
    kernel; ``backward`` [3, 9.5] launching a 0.5-ms kernel and holding
    two ``ff.so.tables.backward`` [4, 5] and [5.5, 6] with kernels of
    1.0 and 0.4 ms, and ``ff.so.degenerate.backward`` [7, 8] with one of
    0.6 ms (launched on autograd's thread: the trace places a launch by
    its time alone)."""
    ops = [DeviceOp('zgemm', 'kernel', ms(0.5), ms(2.5), ms(0.3)),
           DeviceOp('mul', 'kernel', ms(3.1), ms(3.6), ms(3.05)),
           DeviceOp('cumprod', 'kernel', ms(4.2), ms(5.2), ms(4.1)),
           DeviceOp('dgemm', 'kernel', ms(5.6), ms(6.0), ms(5.55)),
           DeviceOp('einsum', 'kernel', ms(7.2), ms(7.8), ms(7.1))]
    spans = [Interval('call', 0, ms(10)), Interval('forward', ms(0.2), ms(3)),
             Interval('backward', ms(3), ms(9.5))]
    if program:
        spans += [Interval('ff.so.tables.backward', ms(4), ms(5)),
                  Interval('ff.so.tables.backward', ms(5.5), ms(6)),
                  Interval('ff.so.degenerate.backward', ms(7), ms(8))]
    return Trace(ops, spans, [])


def test_readers_of_the_spans():
    run_ = Run(synthetic(), 4)
    assert metric('etm.backward.ms_per_pulse').read(run_) == \
        pytest.approx((0.5 + 1.0 + 0.4 + 0.6) / 4)
    assert metric('so.tables.backward.ms_per_pulse').read(run_) == \
        pytest.approx((1.0 + 0.4) / 4)
    assert metric('so.degenerate.backward.ms_per_pulse').read(run_) == \
        pytest.approx(0.6 / 4)


@pytest.mark.parametrize('name', NEW[1:])
def test_left_out_without_the_program_spans(name):
    """A program that opens neither span: their metrics are left out,
    and the entry's ``backward`` is still read."""
    assert metric(name).read(Run(synthetic(program=False), 4)) is None
    assert metric(name).read(Run(None, 4)) is None
    assert metric(NEW[0]).read(Run(synthetic(program=False), 4)) == \
        pytest.approx(2.5 / 4)


def test_only_the_cell_reports_its_metrics():
    reported = {m['name'] for m in manifest.cell(ROOT, CELL).per_layer}
    assert set(NEW) <= reported
    for name in ('qft4.infidelity', 'qft4.gradient', 'qft4_etm2.jitter4',
                 'qft4_etm2_xcorr.jitter4'):
        reported = {m['name'] for m in manifest.cell(ROOT, name).per_layer}
        assert not reported & set(NEW)


def test_the_configuration_is_qft4_etm2s_and_its_objective():
    """Every key of ``qft4_etm2`` with its value, but the name, the
    source, the deployment and the assumptions; besides, the objective
    and what the gradient is taken in; nothing cut."""
    cell = manifest.cell(ROOT, CELL)
    etm2 = manifest.cell(ROOT, 'qft4_etm2.jitter4').config
    own = ('name', 'source', 'deployment', 'assumed')
    assert {k: v for k, v in cell.config.items() if k in etm2
            and k not in own} == {k: v for k, v in etm2.items()
                                  if k not in own}
    assert set(cell.config) - set(etm2) == {'objective', 'grad_wrt'}
    assert cell.config['grad_wrt'] == 'c_coeffs'
    assert cell.config['reduced'] == []
    assert cell.mix['check_calls'] == 2 and cell.mix['directions'] == 2


# -----------------------------------------------------------------------------
# Runs of the cell's files on a small configuration
# -----------------------------------------------------------------------------
@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """A checkout with the cell's entry, mix, reference and limits on the
    2-qubit QFT pulse (d = 4, 7 segments, 7 control and 7 noise
    operators, 16-element basis, 16 frequencies in [0.01, 10]), as new
    files and manifest entries."""
    tmp = tmp_path_factory.mktemp('checkout')
    shutil.copytree(ROOT / 'perfbench', tmp / 'perfbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__',
                                                  'tests'))
    pb = tmp / 'perfbench'
    np.savez(pb / 'data' / 'qft2_arrays.npz', **qft._load(2))
    config = json.loads((pb / 'configs' / 'qft4_etm2_grape.json')
                        .read_text())
    config.update(name='qft2_etm2_grape', n_qubits=2, d=4, n_segments=7,
                  n_ctrl=7, n_nops=7, n_basis=16,
                  arrays='perfbench/data/qft2_arrays.npz',
                  omega={'geomspace': [0.01, 10.0, 16]})
    (pb / 'configs' / 'qft2_etm2_grape.json').write_text(json.dumps(config))
    (pb / 'reference' / 'qft2_etm2_grape.py').write_text(
        'from perfbench.reference.qft4_etm2_grape import Reference  '
        '# noqa: F401\n')
    shutil.copy(pb / 'limits' / f'{CELL}.json',
                pb / 'limits' / f'{SMALL}.json')
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'qft2_etm2_grape', 'source': 'test',
                             'file': 'perfbench/configs/qft2_etm2_grape.json',
                             'reduced': [], 'why': 'test'})
    bench['workloads'].append({'name': SMALL, 'config': 'qft2_etm2_grape',
                               'traffic': 'etm2_grape4', 'chips': 1,
                               'why': 'test'})
    (tmp / 'BENCHMARK.json').write_text(json.dumps(bench))
    return tmp


def result(root, fault: str = 'none') -> dict:
    """The last line of one run of the small cell on the CPU, in a
    subprocess, with *fault* planted."""
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    done = subprocess.run(
        [sys.executable, '-c', RUNNER, str(root), fault, '--workload',
         SMALL, '--seed', str(SEED), '--seconds', '0.3', '--trace', '0'],
        capture_output=True, text=True, env=env, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_the_sound_program_is_correct(root):
    out = result(root)
    assert out['correct'] is True, out['checks']
    assert set(out['checks']) == {'failed_calls', 'etm_rel_gap',
                                  'loss_rel_gap', 'graddir_rel_gap'}


@pytest.mark.parametrize('fault', ['detached', 'no_degenerate'])
def test_a_planted_fault_is_not_correct(root, fault):
    """Either fault leaves the matrices and the losses as they were, and
    moves the gradient's directional derivatives far past the limit."""
    out = result(root, fault)
    assert out['correct'] is False
    checks = out['checks']
    assert checks['etm_rel_gap']['value'] <= checks['etm_rel_gap']['limit']
    assert checks['graddir_rel_gap']['value'] > \
        1e3 * checks['graddir_rel_gap']['limit']


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
    """The reference in float32 in the program's place reads above the
    limit of the gradient's derivatives and of E - I."""
    cell, entry, reference, done = _sampled(root)
    limits = cell.limits['numbers']
    control = entry.compare(entry.control(done, reference), reference)
    assert control['graddir_rel_gap'] > 10 * limits['graddir_rel_gap']
    assert control['etm_rel_gap'] > limits['etm_rel_gap']


def test_the_entry_is_the_functional_path(root):
    """One call of the entry is the port's second-order batched error
    transfer matrix of the jittered rows, bit for bit, and autograd of
    sum ||E - I||_F^2 through it in the rows' amplitudes; the directions
    are orthonormal in each row, and drawn anew for another call."""
    cell = manifest.cell(root, SMALL)
    data = manifest.inputs(cell.config, root)
    entry = manifest.module(root, 'entries', cell.mix['entry']).Entry(
        data, cell.mix, 'cpu', run.trace.Spans())
    calls = run.traffic.calls(cell.mix, cell.config, SEED)
    call = next(calls)
    etm, grad = entry.call(call)
    c = (entry.pulse.c_coeffs[None]
         * torch.as_tensor(call.inputs['scales'])).requires_grad_(True)
    want = functional.batched_error_transfer_matrix(
        entry.pulse._replace(c_coeffs=c), entry.spectrum, entry.omega,
        entry.basis, second_order=True)
    eye = torch.eye(16, dtype=torch.float64)
    want_grad, = torch.autograd.grad(((want - eye) ** 2).sum(), c)
    assert torch.equal(etm, want.detach())
    assert torch.equal(grad, want_grad)
    assert etm.shape == entry.shape(call) == (4, 16, 16)
    assert grad.shape == (4, 7, 7)
    v = entry.directions(call).flatten(2)
    assert v.shape == (4, 2, 49)
    assert torch.allclose(v @ v.mT, torch.eye(2, dtype=v.dtype).expand(
        4, 2, 2), atol=1e-14)
    assert torch.equal(v, entry.directions(call).flatten(2))
    assert not torch.allclose(v, entry.directions(next(calls)).flatten(2))
