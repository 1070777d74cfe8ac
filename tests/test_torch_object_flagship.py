"""The PyTorch port's object API on the flagship: the 4-qubit QFT pulse
(d = 16, 13 segments, 18 noise operators, 256-element GGM basis) built
with ``PulseSequence.from_arrays`` from the JAX package's precomputed
arrays, against the JAX package's PulseSequence built from the same
arrays.

The native route is the CPU default of both packages.  The Ozaki route
runs with the eigendecomposition pinned (JAX's, given to both pulses
through the setters); the JAX oracle runs it with
``FF_TPU_CONTRACT=ozaki``, ``FF_TPU_TRANSFORM_MXU=0`` (exact einsum
conjugations, as the port computes them) and an exact ``exp2``, with
the JAX caches cleared before and after so that no trace made under
these settings is reused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import (convert, functional, numeric,
                                        superoperator)
from filter_functions_tpu_torch.ops import dword
from test_torch_ozaki import _exact_exp2

N_OMEGA = 1000
#: Frequencies of the Ozaki-route comparison: K, J, C and the digit
#: layout are the flagship's, only n_omega shrinks.
N_OMEGA_SMALL = 64


def _omega(n):
    omega = np.geomspace(1e-2, 1e2, n)
    return omega, 1e-4 / omega


def _jax_np(x):
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


@pytest.fixture(scope='module')
def pulses():
    """(JAX pulse, port pulse) of the flagship, from the same arrays."""
    port = fft.qft_pulse_sequence(4, device='cpu')
    jax_pulse = ff.PulseSequence.from_arrays(
        *(getattr(port, f) for f in convert.PULSE_FIELDS))
    return jax_pulse, port


def test_flagship_pulse_from_arrays(pulses):
    """The pulse carries the arrays of qft4_arrays.npz unsorted, on the
    CPU, with the default GGM basis, which is the arrays' basis bit for
    bit."""
    _, port = pulses
    arrays = functional.make_pulse_arrays(port)
    for got, want in zip(arrays, fft.qft_pulse_arrays(4, device='cpu')):
        assert torch.equal(got, want)
    assert port.device == torch.device('cpu') and port.d == 16
    assert len(port) == 13 and port.basis.btype == 'GGM'
    assert list(port.n_oper_identifiers[:2]) == ['B_00', 'B_01']


def test_native_object_path_matches_jax(pulses):
    """fft.infidelity on the pulse at 1000 frequencies, spectrum
    1e-4/omega: within 1e-13 absolute of JAX's ff.infidelity (measured
    2.7e-19 on infidelities up to 3.8e-4) and within 1e-15 relative of the
    port's functional.infidelity (measured 3.3e-16); the fidelity filter
    function is (18, 18, 1000) complex128 and cached, so a second call
    computes nothing."""
    jax_pulse, port = pulses
    omega, spectrum = _omega(N_OMEGA)
    want = np.asarray(ff.infidelity(jax_pulse, spectrum, omega))
    got = fft.infidelity(port, spectrum, omega)
    assert got.shape == (18,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    flat = functional.infidelity(fft.qft_pulse_arrays(4, device='cpu'),
                                 torch.tensor(spectrum), torch.tensor(omega))
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-15,
                               atol=0)
    ff_fid = port.get_filter_function(omega)
    assert ff_fid.shape == (18, 18, N_OMEGA)
    assert ff_fid.dtype == torch.complex128
    ctrl = port.get_control_matrix(omega)
    again = fft.infidelity(port, torch.tensor(spectrum), torch.tensor(omega))
    assert torch.equal(again, got)
    assert port.get_control_matrix(omega) is ctrl


@pytest.fixture(scope='module')
def ozaki_pair(pulses):
    """The Ozaki route of both object paths at 64 frequencies with JAX's
    eigendecomposition: ((JAX infidelity, control matrix), (port
    infidelity, control matrix)).

    The JAX oracle runs unjitted: inside its jitted segment scan XLA
    fuses the float32 assembly of P differently from the op-by-op
    evaluation (4.1e-8 relative on the control matrix, 1.5e-12 on the
    infidelity), and the port computes that assembly op by op."""
    _, port = pulses
    omega, spectrum = _omega(N_OMEGA_SMALL)
    jp = ff.PulseSequence.from_arrays(
        *(getattr(port, f) for f in convert.PULSE_FIELDS))
    jp.diagonalize()
    pulse = fft.qft_pulse_sequence(4, device='cpu')
    for name in ('eigvals', 'eigvecs', 'propagators', 'total_propagator'):
        setattr(pulse, name, _jax_np(getattr(jp, name)))
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('FF_TPU_CONTRACT', 'ozaki')
        mp.setenv('FF_TPU_TRANSFORM_MXU', '0')
        mp.setattr(jnp, 'exp2', _exact_exp2)
        with jax.disable_jit():
            want_ctrl = _jax_np(jp.get_control_matrix(omega))
        want = np.asarray(ff.infidelity(jp, spectrum, omega))
    jax.clear_caches()
    ctrl = numeric.calculate_control_matrix_from_scratch(
        pulse.eigvals, pulse.eigvecs, pulse.propagators, omega, pulse.basis,
        pulse.n_opers_dev, pulse.n_coeffs, pulse.dt, t=pulse.t,
        contract='ozaki')
    pulse.cache_control_matrix(omega, ctrl)
    got = fft.infidelity(pulse, spectrum, omega)
    return (want, want_ctrl), (got.numpy(), ctrl.numpy())


def test_ozaki_object_path_matches_jax(ozaki_pair):
    """With the eigendecomposition pinned, the port's Ozaki route against
    JAX's: infidelities within 1e-12 absolute (measured 1.6e-19), the
    control matrix within 1e-6 max|B| (measured 0: the same digits and
    the same float32 recombination)."""
    (want, want_ctrl), (got, ctrl) = ozaki_pair
    assert got.shape == (18,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ctrl, want_ctrl, rtol=0,
                               atol=1e-6 * np.abs(want_ctrl).max())


def test_ozaki_route_is_near_native(ozaki_pair):
    """The Ozaki route's control matrix is a 24-bit-truncated product:
    within 1e-6 max|B| of the native one (measured 3.3e-7), and its
    infidelities within the 1e-10 contract of the native ones (measured
    8.8e-11)."""
    omega, spectrum = _omega(N_OMEGA_SMALL)
    _, (got, ctrl) = ozaki_pair
    native = fft.qft_pulse_sequence(4, device='cpu')
    native_ctrl = native.get_control_matrix(omega).numpy()
    assert np.abs(ctrl - native_ctrl).max() <= \
        1e-6 * np.abs(native_ctrl).max()
    np.testing.assert_allclose(
        got, fft.infidelity(native, spectrum, omega).numpy(), rtol=0,
        atol=1e-10)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the object path on CUDA launches the '
                    'dword_digits kernel, which has no CPU mode')
    return torch.device('cuda', 0)


@pytest.mark.gpu
def test_object_path_on_card(pulses, cuda_device):
    """On the card the object path takes the Ozaki route through the
    CUDA kernel and lands within the 1e-10 contract of the CPU's native
    route; a second call launches nothing."""
    _, port = pulses
    omega, spectrum = _omega(N_OMEGA_SMALL)
    pulse = fft.qft_pulse_sequence(4, device=cuda_device)
    omega_t = torch.tensor(omega, device=cuda_device)
    before = dword.launches
    got = fft.infidelity(pulse, 1e-4 / omega_t, omega_t)
    assert dword.launches > before
    launched = dword.launches
    fft.infidelity(pulse, 1e-4 / omega_t, omega_t)
    assert dword.launches == launched
    want = fft.infidelity(port, spectrum, omega)
    assert np.abs(got.cpu().numpy() - want.numpy()).max() <= 1e-10


@pytest.mark.gpu
def test_etm_on_card(cuda_device):
    """On the card the first-order ETM of the flagship (chip_smoke phase
    7a at 64 frequencies) launches the kernel through the control
    matrix; -tr K / d^2 is the infidelity within 1e-12 relative, the
    ETM is within 1.6e-9 of the one from a native control matrix (d
    times the 1e-10 infidelity contract), the card's native ETM within
    1e-12 of the CPU's, and the ETM is completely positive."""
    omega = torch.tensor(np.geomspace(1e-2, 1e2, N_OMEGA_SMALL),
                         device=cuda_device)
    spectrum = 1e-4 / omega
    pulse = fft.qft_pulse_sequence(4, device=cuda_device)
    before = dword.launches
    etm = fft.error_transfer_matrix(pulse, spectrum, omega)
    assert dword.launches > before
    assert etm.shape == (256, 256) and etm.dtype == torch.float64
    assert torch.isfinite(etm).all()
    cumulant = numeric.calculate_cumulant_function(pulse, spectrum, omega)
    infid = fft.infidelity(pulse, spectrum, omega).sum().item()
    from_trace = -torch.einsum('aii->', cumulant).item() / pulse.d**2
    assert abs(from_trace - infid) <= 1e-12 * infid
    native = fft.qft_pulse_sequence(4, device=cuda_device)
    native.cache_control_matrix(
        omega, numeric.calculate_control_matrix_from_scratch(
            native.eigvals, native.eigvecs, native.propagators, omega,
            native.basis, native.n_opers_dev, native.n_coeffs, native.dt,
            t=native.t, contract='native'))
    etm_native = fft.error_transfer_matrix(native, spectrum, omega)
    assert (etm - etm_native).abs().max().item() <= 1.6e-9
    cpu = fft.error_transfer_matrix(
        fft.qft_pulse_sequence(4, device='cpu'), spectrum.cpu(), omega.cpu())
    assert (etm_native.cpu() - cpu).abs().max().item() <= 1e-12
    assert superoperator.liouville_is_CP(etm, pulse.basis)
