"""The plain references and the copied traffic generators held against
the program on the CPU, at small sizes.

Run: python -m pytest perfbench/tests -o addopts=''
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import functional, util
from filter_functions_tpu_torch.models import qft, rb
from perfbench.lib import check, manifest, traffic
from perfbench.reference import qft4 as qft_reference
from perfbench.reference import rb1q as rb_reference

ROOT = Path(__file__).resolve().parents[2]


def qft_data(n_qubits: int, n_omega: int) -> dict:
    arrays = qft._load(n_qubits)
    omega = np.geomspace(1e-2, 1e2, n_omega)
    return {'arrays': {k: v.copy() for k, v in arrays.items()},
            'omega': omega, 'spectrum': 1e-4 / omega}


def jittered(data: dict, scales: np.ndarray):
    p = functional.PulseArrays(
        *(torch.as_tensor(data['arrays'][name]) for name in
          ('c_opers', 'c_coeffs', 'n_opers', 'n_coeffs', 'dt', 'basis')))
    b = scales.shape[0]
    return p._replace(c_coeffs=p.c_coeffs[None] * torch.as_tensor(scales),
                      n_coeffs=p.n_coeffs.expand(b, -1, -1).contiguous(),
                      dt=p.dt.expand(b, -1).contiguous())


def test_frozen_qft_arrays_are_the_programs():
    config = json.loads((ROOT / 'perfbench/configs/qft4.json').read_text())
    frozen = manifest.inputs(config, ROOT)['arrays']
    for name, value in qft._load(4).items():
        assert np.array_equal(frozen[name], value), name


def test_frozen_rb_frequencies_are_the_examples():
    config = json.loads((ROOT / 'perfbench/configs/rb1q.json').read_text())
    omega = manifest.omega(config, ROOT)
    pulses = rb.clifford_pulses(device='cpu')
    want = util.get_sample_frequencies(pulses[0], n_samples=301)
    assert np.array_equal(omega, want)


@pytest.mark.parametrize('contract,tol', [('native', 1e-14),
                                          ('ozaki', 3e-7)])
def test_qft_reference_holds_the_program(contract, tol):
    """The flagship at 64 omega, batch 2: the native route to rounding;
    the Ozaki route (its plain digit version on the CPU) to its
    quantization."""
    data = qft_data(4, 64)
    scales = traffic.jitter_scales(np.random.default_rng(1), 2, 0.05)
    p = jittered(data, scales)
    omega = torch.as_tensor(data['omega'])
    got = functional.batched_infidelity(p, torch.as_tensor(data['spectrum']),
                                        omega, contract=contract)
    want = qft_reference.Reference(data, 'cpu').infidelities(
        {'scales': scales})
    assert check.rel_gap(got, want) < tol


def test_qft_reference_gradient_holds_autograd():
    """Central differences of the reference against the program's
    autograd, on the 2-qubit QFT pulse (degenerate segments too)."""
    data = qft_data(2, 32)
    scales = traffic.jitter_scales(np.random.default_rng(2), 2, 0.05)
    p = jittered(data, scales)
    coeffs = p.c_coeffs.clone().requires_grad_(True)
    infid = functional.batched_infidelity(
        p._replace(c_coeffs=coeffs), torch.as_tensor(data['spectrum']),
        torch.as_tensor(data['omega']), contract='native')
    grad, = torch.autograd.grad(infid.sum(), coeffs)
    want = qft_reference.Reference(data, 'cpu').gradient(
        {'scales': scales}, range(2))
    assert check.rel_gap(grad, want) < 1e-9


def test_jitter_is_the_flagships():
    """Rows 1.. of the flagship's batch (chip_smoke._jittered, bench.py's
    default_rng(0)) are the generator's scales for that rng."""
    p = qft.qft_pulse_arrays(4, device='cpu')
    want = chip_smoke._jittered(p, 5).c_coeffs[1:]
    rng = np.random.default_rng(0)
    rng.standard_normal((1, 1, 1))          # the flagship's row 0
    scales = traffic.jitter_scales(rng, 4, 0.05)
    assert torch.equal(p.c_coeffs[None] * torch.as_tensor(scales), want)


def test_cliffords_are_the_programs():
    mine, theirs = traffic.clifford_group(), rb.clifford_group()
    assert [w for _, w in mine] == [w for _, w in theirs]
    assert all(np.allclose(u, v) for (u, _), (v, _) in zip(mine, theirs))


def test_recovery_by_table_is_the_programs():
    """Each row's recovery gate, composed by the Clifford table, is the
    one ``models.rb.sample_sequence`` finds by matrix products."""
    group = list(rb.clifford_group())
    for length in (1, 6, 101):
        rows = traffic.sample_sequences(20, length,
                                        np.random.default_rng(length))
        assert rows.shape == (20, length + 1)
        for row in rows:
            total = np.eye(2, dtype=complex)
            for i in row[:-1]:
                total = group[i][0] @ total
            assert rb._find(group, total.conj().T) == row[-1]


@pytest.mark.parametrize('length', [1, 6])
def test_rb_reference_holds_the_program(length):
    omega = np.array(json.loads(
        (ROOT / 'perfbench/data/rb1q_omega.json').read_text()))
    spectrum = 1e-4 / omega
    data = {'config': {'tau': 1.0}, 'omega': omega, 'spectrum': spectrum}
    inputs = traffic.DRAWS['clifford_sequences'](
        {'batch': 6}, length, np.random.default_rng(length))
    want = rb_reference.Reference(data, 'cpu').infidelities(inputs)[:, 0]
    batched = rb.batched_rb_infidelities(inputs['indices'], omega, spectrum,
                                         device='cpu')
    assert check.rel_gap(batched[:, None], want[:, None]) < 1e-12
    pulses = rb.clifford_pulses(omega=omega, device='cpu')
    for row, value in zip(inputs['indices'], want):
        seq = rb.rb_pulse([int(i) for i in row[:-1]], int(row[-1]), pulses)
        got = fft.infidelity(seq, spectrum, omega)
        assert abs(float(got[0]) - float(value)) < 1e-12 * float(value)


def test_sizes_cycle_in_a_seeded_order():
    sizes = [1, 6, 11, 16]
    a = traffic.size_order(sizes, 12345678901)
    first = [next(a) for _ in range(8)]
    assert sorted(first[:4]) == sizes and sorted(first[4:]) == sizes
    b = traffic.size_order(sizes, 12345678901)
    assert [next(b) for _ in range(8)] == first
    c = traffic.size_order(sizes, 5)
    assert [next(c) for _ in range(40)] != first * 5
