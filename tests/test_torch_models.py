"""The port's pulse families (filter_functions_tpu_torch.models: dd, the
live qft, rb, exchange) and its closed forms
(filter_functions_tpu_torch.analytic)
against the JAX package's constructors, pulse for pulse, and against their
own oracles (closed-form filter functions, the ideal QFT unitary, the
Clifford group); and a guard that the port runs with JAX and the JAX
package out of reach.

Everything runs on the CPU (``device='cpu'``) at d <= 16 and <= 100
frequencies.  Bounds are stated per test.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu import analytic as janalytic
from filter_functions_tpu.models import dd as jdd
from filter_functions_tpu.models import exchange as jexchange
from filter_functions_tpu.models import qft as jqft
from filter_functions_tpu.models import rb as jrb
from filter_functions_tpu_torch import analytic, convert, util
from filter_functions_tpu_torch.models import dd, exchange, qft, rb
from torch_testutil import QFT_NPZ

REPO = Path(__file__).resolve().parents[1]


def _same_pulse(port, jax_pulse):
    """The port's pulse carries the JAX pulse's arrays bit for bit."""
    for name in convert.PULSE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_pulse, name), err_msg=name)
    np.testing.assert_array_equal(port.basis.np, jax_pulse.basis.np)


# -----------------------------------------------------------------------------
# analytic and dd
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('name,args', [('FID', ()), ('SE', ()), ('PDD', (4,)),
                                       ('PDD', (5,)), ('CPMG', (4,)),
                                       ('CPMG', (5,)), ('CDD', (3,)),
                                       ('UDD', (4,))])
def test_analytic_equals_jax(name, args):
    """The port's own copy of the closed forms gives the JAX package's
    values bit for bit."""
    z = np.logspace(-1, 2, 50)
    np.testing.assert_array_equal(getattr(analytic, name)(z, *args),
                                  getattr(janalytic, name)(z, *args))


@pytest.mark.parametrize('dd_type,n,oracle', [('cpmg', 4, 'CPMG'),
                                              ('cpmg', 5, 'CPMG'),
                                              ('udd', 4, 'UDD'),
                                              ('pdd', 5, 'PDD'),
                                              ('cdd', 3, 'CDD')])
def test_dd_against_analytic(dd_type, n, oracle):
    """dd_pulse's fidelity filter function at 100 frequencies against
    the port's closed form / omega^2: 1e-10 absolute, the bound
    tests/test_models.py holds the JAX package to (measured <= 4e-13);
    the pulse is the JAX constructor's, bit for bit."""
    tau = np.pi
    pulse = dd.dd_pulse(n, tau=tau, tau_pi=1e-9, dd_type=dd_type,
                        device='cpu')
    _same_pulse(pulse, jdd.dd_pulse(n, tau=tau, tau_pi=1e-9,
                                    dd_type=dd_type))
    omega = np.logspace(0, 2, 100)
    got = pulse.get_filter_function(omega)[0, 0].real.numpy()
    want = getattr(analytic, oracle)(omega * tau, n) / omega**2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_dd_dcg_pulses_and_errors():
    """The 'dcg' pulse shape gives the JAX constructor's pulse; unknown
    sequence and pulse types raise."""
    _same_pulse(dd.dd_pulse(3, dd_type='udd', pulse_type='dcg', tau_pi=1e-3,
                            device='cpu'),
                jdd.dd_pulse(3, dd_type='udd', pulse_type='dcg', tau_pi=1e-3))
    with pytest.raises(ValueError, match='Unknown dd_type'):
        dd.dd_pulse(3, dd_type='xy4', device='cpu')
    with pytest.raises(ValueError, match='Unknown pulse_type'):
        dd.dd_pulse(3, pulse_type='gauss', device='cpu')


def test_spin_echo_and_fid():
    """Spin echo and free induction decay against SE and FID (1e-10 and
    1e-12 absolute, as tests/test_models.py) and the JAX constructors."""
    pulse = dd.spin_echo_pulse(tau=np.pi, tau_pi=1e-9, device='cpu')
    _same_pulse(pulse, jdd.spin_echo_pulse(tau=np.pi, tau_pi=1e-9))
    omega = np.logspace(0, 2, 50)
    got = pulse.get_filter_function(omega)[0, 0].real.numpy()
    np.testing.assert_allclose(got, analytic.SE(omega * np.pi) / omega**2,
                               rtol=0, atol=1e-10)
    pulse = dd.fid_pulse(tau=2.0, device='cpu')
    _same_pulse(pulse, jdd.fid_pulse(tau=2.0))
    omega = np.linspace(0.1, 20, 100)
    got = pulse.get_filter_function(omega)[0, 0].real.numpy()
    np.testing.assert_allclose(got, analytic.FID(omega * 2.0) / omega**2,
                               rtol=0, atol=1e-12)


# -----------------------------------------------------------------------------
# qft
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('n_qubits', [1, 2, 3, 4])
def test_qft_pulse_propagator_and_jax_parity(n_qubits):
    """The live QFT pulse implements the QFT (its total propagator with
    the qubit order reversed is the ideal unitary up to a phase, eps
    1e-10), has 3 n + 1 segments and normalized noise operators, and is
    the JAX constructor's pulse bit for bit."""
    pulse = qft.qft_pulse(n_qubits, device='cpu')
    assert pulse.d == 2**n_qubits and len(pulse) == 3 * n_qubits + 1
    assert pulse.device == torch.device('cpu')
    _same_pulse(pulse, jqft.qft_pulse(n_qubits))
    prop = qft.swap_all(n_qubits) @ pulse.total_propagator.numpy()
    eq, _ = util.oper_equiv(prop, qft.qft_propagator(n_qubits), eps=1e-10)
    assert eq
    np.testing.assert_allclose(np.linalg.norm(pulse.n_opers, axis=(1, 2)),
                               1.0, atol=1e-12)
    np.testing.assert_array_equal(qft.qft_propagator(n_qubits),
                                  jqft.qft_propagator(n_qubits))
    np.testing.assert_array_equal(qft.swap_all(n_qubits),
                                  jqft.swap_all(n_qubits))


def test_live_flagship_equals_precomputed_arrays():
    """qft_pulse(4) equals the JAX package's precomputed flagship arrays
    exactly (max |diff| = 0 on all five arrays, in the same operator
    order, and on the basis); qft_pulse_arrays and qft_pulse_sequence
    carry the same arrays with generic operator names."""
    with np.load(QFT_NPZ) as z:
        z = dict(z)
    pulse = qft.qft_pulse(4, device='cpu')
    assert list(pulse.c_oper_identifiers[:3]) == ['IIIX', 'IIIY', 'IIIZ']
    assert pulse.c_oper_identifiers[-1] == 'ZZII'
    want = dict(c_opers=z['c_opers_re'] + 1j * z['c_opers_im'],
                n_opers=z['n_opers_re'] + 1j * z['n_opers_im'],
                c_coeffs=z['c_coeffs'], n_coeffs=z['n_coeffs'], dt=z['dt'])
    for name, value in want.items():
        assert np.abs(getattr(pulse, name) - value).max() == 0, name
    arrays = qft.qft_pulse_arrays(4, device='cpu')
    for name, value in want.items():
        assert np.abs(getattr(arrays, name).numpy() - value).max() == 0, name
    basis = z['basis_re'] + 1j * z['basis_im']
    assert np.abs(arrays.basis.numpy() - basis).max() == 0
    named = qft.qft_pulse_sequence(4, device='cpu')
    assert list(named.c_oper_identifiers[:2]) == ['A_00', 'A_01']
    assert named.n_oper_identifiers[-1] == 'B_17'
    for name in want:
        np.testing.assert_array_equal(getattr(named, name),
                                      getattr(pulse, name))
    assert fft.qft_pulse_sequence is qft.qft_pulse_sequence


def test_flagship_builders_do_not_share_their_arrays():
    """An in-place edit of one flagship pulse's host arrays or CPU
    tensors (an amplitude scan) reaches no pulse built after it: the
    builders hand out copies of the arrays they cache."""
    first = qft.qft_pulse_sequence(2, device='cpu')
    arrays = qft.qft_pulse_arrays(2, device='cpu')
    want = first.c_coeffs.copy()
    first.c_coeffs *= 2
    first.dt[:] = 7
    arrays.c_coeffs.mul_(3)
    again = qft.qft_pulse_sequence(2, device='cpu')
    np.testing.assert_array_equal(again.c_coeffs, want)
    np.testing.assert_array_equal(
        qft.qft_pulse_arrays(2, device='cpu').c_coeffs.numpy(), want)
    assert again.dt.max() < 7


@pytest.mark.parametrize('build,jbuild,args', [
    ('r_k_pulse', 'r_k_pulse', (1, 0.7, -0.3, 3)),
    ('t_i_pulse', 't_i_pulse', (3,)), ('t_i_pulse', 't_i_pulse', (1,)),
    ('t_f_pulse', 't_f_pulse', (3,)), ('t_f_pulse', 't_f_pulse', (1,)),
    ('p_n_pulse', 'p_n_pulse', (1, 3)), ('h_k_pulse', 'h_k_pulse', (2, 3))])
def test_qft_gates_equal_jax(build, jbuild, args):
    """Every gate constructor of the QFT gives the JAX constructor's pulse, bit
    for bit, on the device it is asked for."""
    pulse = getattr(qft, build)(*args, device='cpu')
    assert pulse.device == torch.device('cpu')
    _same_pulse(pulse, getattr(jqft, jbuild)(*args))


def test_qft_composed_filter_function_matches_scratch():
    """The 3-qubit QFT composed from its 7 gates with cached filter
    functions (K5 over Hadamards that are themselves concatenations)
    against the pulse's own from-scratch filter function at 30
    frequencies: 1e-12 of the largest entry (measured 1e-15)."""
    omega = np.geomspace(1e-2, 1e2, 30)
    gates = qft._qft_atomic_pulses(3, device='cpu')
    assert len(gates) == 7
    for gate in gates:
        gate.cache_filter_function(omega)
    composed = fft.concatenate(gates)
    assert composed.is_cached('filter_function')
    assert composed == qft.qft_pulse(3, device='cpu')
    want = qft.qft_pulse(3, device='cpu').get_filter_function(omega).numpy()
    np.testing.assert_allclose(composed.get_filter_function(omega).numpy(),
                               want, rtol=0, atol=1e-12 * np.abs(want).max())


# -----------------------------------------------------------------------------
# rb
# -----------------------------------------------------------------------------
def test_clifford_group_and_control_arrays():
    """24 Cliffords, closed under multiplication, with the JAX package's
    words; the padded control arrays are JAX's."""
    group = rb.clifford_group()
    assert len(group) == 24
    assert [w for _, w in group] == [w for _, w in jrb.clifford_group()]
    local = np.random.default_rng(0)
    for _ in range(20):
        i, j = local.integers(0, 24, 2)
        assert rb._find(list(group), group[i][0] @ group[j][0]) >= 0
    for got, want in zip(rb.clifford_control_arrays(1.5),
                         jrb.clifford_control_arrays(1.5)):
        np.testing.assert_array_equal(got, want)


def test_clifford_pulses_implement_group():
    """The 24 pulses equal the JAX constructor's and implement the group
    elements (up to a phase, eps 1e-9)."""
    pulses = rb.clifford_pulses(device='cpu')
    for (u, word), pulse, jpulse in zip(rb.clifford_group(), pulses,
                                        jrb.clifford_pulses()):
        _same_pulse(pulse, jpulse)
        eq, _ = util.oper_equiv(pulse.total_propagator.numpy(), u, eps=1e-9)
        assert eq, word


@pytest.mark.parametrize('length', [1, 3, 8])
def test_rb_sequence_identity(length):
    """A sampled sequence plus its recovery gate implements the identity
    (eps 1e-8), and the sampler draws the JAX package's indices."""
    pulses = rb.clifford_pulses(device='cpu')
    idx, rec = rb.sample_sequence(length, np.random.default_rng(7))
    assert (idx, rec) == jrb.sample_sequence(length,
                                             np.random.default_rng(7))
    seq = rb.rb_pulse(idx, rec, pulses)
    eq, _ = util.oper_equiv(seq.total_propagator.numpy(), np.eye(2),
                            eps=1e-8)
    assert eq


def test_rb_cached_concatenation_matches_scratch():
    """rb_pulse from Cliffords with cached filter functions against the
    merged pulse from scratch at 40 frequencies (1e-11 absolute, as
    tests/test_models.py; measured 2e-14)."""
    omega = np.linspace(0.5, 20, 40)
    pulses = rb.clifford_pulses(omega=omega, device='cpu')
    idx, rec = rb.sample_sequence(4, np.random.default_rng(3))
    seq = rb.rb_pulse(idx, rec, pulses)
    assert seq.is_cached('filter function')
    fresh = fft.PulseSequence.from_arrays(
        *(getattr(seq, f) for f in convert.PULSE_FIELDS), basis=seq.basis,
        device='cpu')
    np.testing.assert_allclose(seq.get_filter_function(omega).numpy(),
                               fresh.get_filter_function(omega).numpy(),
                               rtol=0, atol=1e-11)
    assert not rb.rb_pulse(idx, rec, pulses,
                           calc_filter_function=False).is_cached(
                               'filter function')


def test_batched_rb_infidelities():
    """batched_rb_infidelities of 6 sequences of 10 Cliffords plus
    recovery at 61 frequencies: within 1e-12 relative of the JAX
    package's (measured 6e-15) and of fft.infidelity on rb_pulse by
    concatenate (measured 4e-15); the atomic data are cached per (tau,
    omega, device), so a second call with another spectrum builds
    nothing."""
    local = np.random.default_rng(0)
    seqs = []
    for _ in range(6):
        idx, rec = rb.sample_sequence(10, local)
        seqs.append(idx + [rec])
    omega = np.geomspace(1e-2, 1e2, 61)
    spectrum = 1e-3 / omega
    rb._atomic_clifford_data.cache_clear()
    got = rb.batched_rb_infidelities(seqs, omega, spectrum, device='cpu')
    assert got.shape == (6,) and got.dtype == torch.float64
    want = np.asarray(jrb.batched_rb_infidelities(np.asarray(seqs), omega,
                                                  spectrum))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    pulses = rb.clifford_pulses(omega=omega, device='cpu')
    for row in (0, 5):
        one = rb.rb_pulse(seqs[row][:-1], seqs[row][-1], pulses)
        np.testing.assert_allclose(
            fft.infidelity(one, spectrum, omega).numpy()[0],
            got[row].item(), rtol=1e-12, atol=0)
    again = rb.batched_rb_infidelities(seqs, torch.tensor(omega),
                                       2 * spectrum, device='cpu')
    assert rb._atomic_clifford_data.cache_info().misses == 1
    np.testing.assert_allclose(again.numpy(), 2 * got.numpy(), rtol=1e-14)


# -----------------------------------------------------------------------------
# exchange
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('n_spins', [2, 3, 4])
def test_heisenberg_operators_equal_jax(n_spins):
    """The exchange and gradient operators are the JAX package's, bit for
    bit, and commute with the total S_z."""
    got, want = exchange.heisenberg_operators(n_spins), \
        jexchange.heisenberg_operators(n_spins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sz = sum(util.tensor(*[util.paulis[3] if k == j else util.paulis[0]
                           for k in range(n_spins)])
             for j in range(n_spins)).real
    for op in (*got[0], *got[1]):
        np.testing.assert_allclose(op @ sz - sz @ op, 0, atol=1e-12)


def test_dial_spectrum_equals_jax():
    w = np.geomspace(0.1, 10, 7)
    for alpha in (0.0, 0.7, 1.0):
        np.testing.assert_array_equal(exchange.dial_spectrum(w, alpha),
                                      jexchange.dial_spectrum(w, alpha))
    assert exchange.CNOT_SUBSPACE == jexchange.CNOT_SUBSPACE


def _cnot_mat(path, n_dt, seed):
    """A .mat file with the fields and shapes of the published CNOT.mat:
    eps (3, n_dt), t (n_dt,) and B (3,)."""
    from scipy import io
    rng = np.random.default_rng(seed)
    io.savemat(str(path), {'eps': rng.normal(0, 1, (3, n_dt)),
                           't': 0.5 + rng.random(n_dt),
                           'B': rng.normal(0, 1, 3)})
    return path


def test_cnot_pulse_equals_jax(tmp_path):
    """cnot_pulse on a 20-segment .mat the test writes: the JAX package's
    pulse bit for bit; its infidelity in qubit_subspace_basis() with d =
    4, the Dial spectrum at 200 frequencies, within 1e-12 relative of
    JAX's (measured 2.4e-15).  A missing file raises
    FileNotFoundError; the default device is the card."""
    path = _cnot_mat(tmp_path / 'cnot.mat', 20, 9)
    got = exchange.cnot_pulse(str(path), device='cpu')
    want = jexchange.cnot_pulse(str(path))
    _same_pulse(got, want)
    omega = np.geomspace(1 / got.tau, 1e2, 200)
    ids = ['eps_12', 'eps_23', 'eps_34']
    infids = []
    for pulse, mod in ((got, fft), (want, ff)):
        pulse.basis = exchange.qubit_subspace_basis() if mod is fft \
            else jexchange.qubit_subspace_basis()
        pulse.d = 4
        infids.append(np.asarray(mod.infidelity(
            pulse, exchange.dial_spectrum(omega), omega, ids)))
    np.testing.assert_allclose(infids[0], infids[1], rtol=1e-12)
    np.testing.assert_array_equal(exchange.qubit_subspace_basis().np,
                                  jexchange.qubit_subspace_basis().np)
    assert exchange.qubit_subspace_basis().btype == 'Custom'
    with pytest.raises(FileNotFoundError, match='data_path'):
        exchange.cnot_pulse(str(tmp_path / 'missing.mat'), device='cpu')
    assert exchange.CNOT_DATA == REPO / 'examples' / 'data' / 'CNOT.mat'
    import inspect
    assert inspect.signature(exchange.cnot_pulse).parameters[
        'device'].default == 'cuda'


# -----------------------------------------------------------------------------
# the port stands alone
# -----------------------------------------------------------------------------
def test_port_runs_without_jax_and_without_the_jax_package(tmp_path):
    """In a fresh interpreter whose working directory is outside the
    repository, with only the port's package on the path, ``jax`` and
    ``filter_functions_tpu`` blocked in ``sys.modules`` and every open of
    a file under the JAX package's directory refused: the port and all
    its submodules import, qft_pulse_arrays(4, device='cpu') builds the
    flagship's arrays, and two pulses concatenate."""
    link = tmp_path / 'site' / 'filter_functions_tpu_torch'
    link.parent.mkdir()
    link.symlink_to(REPO / 'filter_functions_tpu_torch',
                    target_is_directory=True)
    code = textwrap.dedent(f'''
        import builtins, importlib, importlib.util, io, pkgutil, sys
        sys.path[:] = [p for p in sys.path
                       if p and not p.startswith({str(REPO)!r})]
        sys.path.insert(0, {str(link.parent)!r})
        for name in ('jax', 'jaxlib', 'filter_functions_tpu'):
            sys.modules[name] = None
        forbidden = {str(REPO / 'filter_functions_tpu')!r} + '/'
        real_open = io.open
        def guarded(file, *args, **kwargs):
            if isinstance(file, (str, bytes)) or hasattr(file, '__fspath__'):
                import os
                if os.path.realpath(os.fspath(file)).startswith(forbidden):
                    raise AssertionError(f'opened {{file}}')
            return real_open(file, *args, **kwargs)
        builtins.open = io.open = guarded
        import filter_functions_tpu_torch as fft
        names = [m.name for m in pkgutil.walk_packages(
            fft.__path__, fft.__name__ + '.')]
        for name in names:
            if name.endswith('.plotting') and \\
                    importlib.util.find_spec('matplotlib') is None:
                continue            # the module needs matplotlib
            importlib.import_module(name)
        assert len(names) >= 21, names
        p = fft.qft_pulse_arrays(4, device='cpu')
        assert p.c_opers.shape == (18, 16, 16) and p.dt.shape == (13,)
        a = fft.models.dd.spin_echo_pulse(device='cpu')
        assert len(a @ a) == 6
        bad = [m for m in sys.modules if sys.modules[m] is not None
               and (m == 'jax' or m.startswith(('jax.', 'jaxlib',
                                                'filter_functions_tpu.')))]
        assert not bad, bad
        print('ok', len(names))
        ''')
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith('ok')
