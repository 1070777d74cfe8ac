"""The harness on the CPU: a cell and a metric added as new files only
are found and run; a run with the timed path broken underneath comes
out not correct, once for each fault a cell can have; the control (the
reference one precision lower in the program's place) fails each cell's
limit.

The runs skip the look for a card (``run.main(..., device='cpu')``) and
use small configurations: the 2-qubit QFT pulse at 32 frequencies in
place of the 4-qubit one, which the tests freeze into new files.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from filter_functions_tpu_torch import functional
from filter_functions_tpu_torch.models import qft, rb
from perfbench import run
from perfbench.lib import check, manifest, traffic

ROOT = Path(__file__).resolve().parents[2]
SEED = 3000000123


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """A checkout with two more cells of the 2-qubit QFT pulse, their
    configuration, data, reference and limits, and one more metric, all
    as new files and manifest entries."""
    tmp = tmp_path_factory.mktemp('checkout')
    shutil.copytree(ROOT / 'perfbench', tmp / 'perfbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__',
                                                  'tests'))
    pb = tmp / 'perfbench'
    np.savez(pb / 'data' / 'qft2_arrays.npz', **qft._load(2))
    config = json.loads((pb / 'configs' / 'qft4.json').read_text())
    config.update(name='qft2', n_qubits=2, d=4, n_segments=7,
                  arrays='perfbench/data/qft2_arrays.npz',
                  omega={'geomspace': [0.01, 100.0, 32]})
    (pb / 'configs' / 'qft2.json').write_text(json.dumps(config))
    (pb / 'reference' / 'qft2.py').write_text(
        'from perfbench.reference.qft4 import Reference  # noqa: F401\n')
    for cell in ('infidelity', 'gradient'):
        shutil.copy(pb / 'limits' / f'qft4.{cell}.json',
                    pb / 'limits' / f'qft2.{cell}.json')
    (pb / 'metrics' / 'dummy.calls.py').write_text(
        'def read(run):\n'
        '    return float(len(run.spans.host_s["call"]))\n')
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'qft2', 'source': 'test',
                             'file': 'perfbench/configs/qft2.json',
                             'reduced': [], 'why': 'test'})
    bench['workloads'] += [
        {'name': 'qft2.infidelity', 'config': 'qft2',
         'traffic': 'jitter8_chunk2', 'chips': 1, 'why': 'test'},
        {'name': 'qft2.gradient', 'config': 'qft2',
         'traffic': 'grad4_chunk2', 'chips': 1, 'why': 'test'}]
    # the RB cells, whose files are kept though the manifest leaves them
    # out (their host-bound rates spread too widely to hold a bound),
    # are manifest entries away
    if 'rb1q' not in [c['name'] for c in bench['configs']]:
        bench['configs'].append({'name': 'rb1q', 'source': 'test',
                                 'file': 'perfbench/configs/rb1q.json',
                                 'reduced': [], 'why': 'test'})
    for name, mix in (('rb1q.batched', 'lengths_batched50'),
                      ('rb1q.concatenate', 'lengths_single')):
        if name not in [w['name'] for w in bench['workloads']]:
            bench['workloads'].append({'name': name, 'config': 'rb1q',
                                       'traffic': mix, 'chips': 1,
                                       'why': 'test'})
    bench['per_layer'].append({'name': 'dummy.calls', 'unit': 'calls',
                               'better': 'higher', 'source': 'program_span',
                               'layer': 'test', 'moves': 'pulses_per_s',
                               'workloads': ['qft2.infidelity']})
    (tmp / 'BENCHMARK.json').write_text(json.dumps(bench))
    return tmp


def result(root, capsys, workload, trace=0, seconds=0.3):
    rc = run.main(['--workload', workload, '--seed', str(SEED),
                   '--seconds', str(seconds), '--trace', str(trace)],
                  root=root, device='cpu')
    out = capsys.readouterr().out
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def test_new_files_are_found_by_name(root, capsys):
    cell = manifest.cell(root, 'qft2.infidelity')
    assert cell.config['name'] == 'qft2'
    assert 'dummy.calls' in [m['name'] for m in cell.per_layer]
    traced = result(root, capsys, 'qft2.infidelity', trace=1)
    assert traced['correct'] is True
    assert traced['metrics']['dummy.calls']['value'] == traced['attempted']
    assert list(traced)[-1] == 'checks'
    plain = result(root, capsys, 'qft2.infidelity')
    assert set(plain['metrics']) == {'pulses_per_s', 'call_ms_p95',
                                     'peak_mem_gib', 'setup_s'}


# -----------------------------------------------------------------------------
# Faults of the timed path
# -----------------------------------------------------------------------------
def half_batch(fn):
    """The first half of the batch computed, the rest set to its mean."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        half = out.shape[0] // 2
        return torch.cat([out[:half],
                          out[:half].mean(0, keepdim=True).expand(
                              out.shape[0] - half, *out.shape[1:])])
    return broken


def altered(fn, share=1e-5):
    """One answer of each call off by *share* of itself."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out.view(-1)[0] *= 1 + share
        return out
    return broken


class _ScaledBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * (1 + 1e-3)


def gradient_altered(fn):
    """The infidelities right, their gradient off by 1e-3 of itself."""
    def broken(p, *args, **kwargs):
        return fn(p._replace(c_coeffs=_ScaledBackward.apply(p.c_coeffs)),
                  *args, **kwargs)
    return broken


FAULTS = [
    ('qft2.infidelity', functional, 'batched_infidelity', half_batch),
    ('qft2.infidelity', functional, 'batched_infidelity', altered),
    ('qft2.gradient', functional, 'batched_infidelity', half_batch),
    ('qft2.gradient', functional, 'batched_infidelity', altered),
    ('qft2.gradient', functional, 'batched_infidelity', gradient_altered),
    ('rb1q.batched', rb, 'batched_rb_infidelities', half_batch),
    ('rb1q.batched', rb, 'batched_rb_infidelities', altered),
]


@pytest.mark.parametrize('workload,module,name,fault', FAULTS,
                         ids=[f'{w}-{f.__name__}' for w, _, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, capsys, monkeypatch,
                                            workload, module, name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    assert result(root, capsys, workload)['correct'] is False


def test_an_altered_sequence_is_not_correct(root, capsys, monkeypatch):
    """rb1q.concatenate sends one sequence a call, so no half batch."""
    import filter_functions_tpu_torch as fft
    monkeypatch.setattr(fft, 'infidelity', altered(fft.infidelity))
    assert result(root, capsys, 'rb1q.concatenate')['correct'] is False


@pytest.mark.parametrize('workload', ['qft2.infidelity', 'qft2.gradient',
                                      'rb1q.batched'])
def test_the_sound_program_is_correct(root, capsys, workload):
    assert result(root, capsys, workload)['correct'] is True


# -----------------------------------------------------------------------------
# The control
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('workload', ['qft2.infidelity', 'qft2.gradient',
                                      'rb1q.batched', 'rb1q.concatenate'])
def test_the_control_fails_the_limits(root, workload):
    """The reference in float32 in the program's place, on the window's
    sampled calls, reads above at least one limit of the cell."""
    cell = manifest.cell(root, workload)
    device = torch.device('cpu')
    entry, data, spans = run.set_up(cell, root, device, SEED, False)
    win = run.window(entry, cell, device, SEED, 0.2, spans)
    reference = manifest.module(root, 'reference',
                                cell.workload['config']).Reference(data,
                                                                   device)
    picked = check.sample_calls([c.size for c, _ in win.done],
                                int(cell.mix['check_calls']), SEED)
    done = entry.control([win.done[i] for i in picked], reference)
    numbers = entry.compare(done, reference)
    correct, _ = run.verdict(numbers, cell.limits['numbers'], 0)
    assert not correct, numbers
    assert traffic.SEED_MOD > SEED


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('workload', ['qft4.infidelity', 'qft4.gradient'])
def test_a_short_run_on_the_card_is_correct(card, capsys, workload):
    """Run on the card: python -m pytest perfbench/tests -m gpu
    -o addopts=''."""
    rc = run.main(['--workload', workload, '--seed', str(SEED),
                   '--seconds', '2', '--trace', '1'])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['correct'] is True
    assert line['device']['platform'] == 'gpu'
    assert 0 < line['device']['busy_s'] <= line['device']['window_s']
