"""The PyTorch port's error transfer matrix (K16) against the JAX
package's: the object API (``fft.error_transfer_matrix`` of a
PulseSequence) and the functional API (``functional.
error_transfer_matrix`` / ``batched_error_transfer_matrix`` of
PulseArrays), first and second order, for random pulses with seeded
generators (d <= 4, <= 40 frequencies) and spectra of ndim 1-3; and the
flagship (the 4-qubit QFT pulse, n_b = 256, so the trace contraction
runs through the basis) at 64 frequencies.  Tolerance 1e-13 absolute
unless stated; both sides run the native complex128 route on the CPU.
"""
import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu import numeric as jnumeric
from filter_functions_tpu_torch import convert, functional, numeric
from filter_functions_tpu_torch.superoperator import liouville_is_CP
from testutil import make_pulse, rand_pulse_arrays
from torch_testutil import fft_cpu

KINDS = ['shared', 'per_operator', 'cross', 'complex_cross']


def _pair(d, n_dt, seed, btype='GGM'):
    arrays = rand_pulse_arrays(d, n_dt, 3, 2,
                               local_rng=np.random.default_rng(seed))
    return make_pulse(arrays, btype), make_pulse(arrays, btype, cls=fft_cpu)


def _spectrum(kind, omega):
    if kind == 'shared':
        return 1e-3 / omega
    if kind == 'per_operator':
        return np.outer([1e-3, 2e-3], 400 / (omega**2 + 400))
    off = (1e-4 + 1j * 1e-4) / omega if kind == 'complex_cross' \
        else 3e-4 / omega
    return np.array([[1e-3 / omega, off], [np.conj(off), 2e-3 / omega]])


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('d,btype', [(2, 'Pauli'), (3, 'GGM'), (4, 'GGM')])
def test_object_etm_matches_jax(d, btype, kind):
    """fft.error_transfer_matrix of a PulseSequence, first and second
    order and memory-parsimonious, against ff.error_transfer_matrix; the
    result is completely positive, and -tr K / d^2 of the first-order
    cumulant function is the infidelity within 1e-12 relative."""
    jp, p = _pair(d, 3, 10 * d + KINDS.index(kind), btype)
    omega = np.geomspace(0.1, 20, 32)
    spectrum = _spectrum(kind, omega)
    for second in (False, True):
        want = np.asarray(ff.error_transfer_matrix(jp, spectrum, omega,
                                                   second_order=second))
        got = fft.error_transfer_matrix(p, spectrum, omega,
                                        second_order=second)
        assert got.shape == (d * d, d * d) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
        assert liouville_is_CP(got, p.basis)
    k = numeric.calculate_cumulant_function(p, spectrum, omega)
    infid = fft.infidelity(p, spectrum, omega).sum().item()
    np.testing.assert_allclose(
        -torch.diagonal(k, 0, -2, -1).sum().item() / d**2, infid,
        rtol=1e-12)
    parsimonious = fft.error_transfer_matrix(p, spectrum, omega,
                                             memory_parsimonious=True)
    np.testing.assert_allclose(
        parsimonious.numpy(),
        np.asarray(ff.error_transfer_matrix(jp, spectrum, omega)),
        rtol=0, atol=1e-13)


def test_etm_from_cumulant_and_errors():
    """A given cumulant function (tensor or numpy, summed over its
    leading axes) is exponentiated as JAX does; bad arguments raise as
    in tests/test_precision.py::test_error_transfer_matrix_raises."""
    k = 1e-2 * np.random.default_rng(3).normal(size=(2, 4, 4))
    want = np.asarray(ff.error_transfer_matrix(cumulant_function=k))
    for given in (k, torch.as_tensor(k)):
        got = fft.error_transfer_matrix(cumulant_function=given)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match='Require either'):
        fft.error_transfer_matrix()
    with pytest.raises(TypeError):
        fft.error_transfer_matrix(cumulant_function=[1, 2, 3])
    for shape in ((2, 3), (3,)):
        with pytest.raises(ValueError):
            fft.error_transfer_matrix(cumulant_function=np.zeros(shape))


def _arrays(jp):
    """(JAX PulseArrays, port PulseArrays) of a JAX pulse."""
    jarr = jfunctional.make_pulse_arrays(jp)
    return jarr, convert.pulse_arrays_from_numpy(
        jfunctional.PulseArrays(*(
            x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)
            for x in jarr)), device='cpu')


@pytest.mark.parametrize('kind', KINDS)
def test_functional_etm_matches_jax(kind):
    """functional.error_transfer_matrix against JAX's functional one and
    against the port's object path, first and second order (real
    diagonal spectra take the folded routes, the others the
    integrands)."""
    jp, p = _pair(3, 4, 40 + KINDS.index(kind))
    omega = np.geomspace(0.1, 10, 24)
    spectrum = _spectrum(kind, omega)
    jarr, arr = _arrays(jp)
    for second in (False, True):
        want = np.asarray(jfunctional.error_transfer_matrix(
            jarr, spectrum, omega, jp.basis, second_order=second))
        got = functional.error_transfer_matrix(arr, spectrum, omega,
                                               p.basis, second_order=second)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
        obj = fft.error_transfer_matrix(p, spectrum, omega,
                                        second_order=second)
        np.testing.assert_allclose(got.numpy(), obj.numpy(), rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize('kind', ['shared', 'per_operator', 'cross'])
def test_batched_etm_matches_single(kind):
    """batched_error_transfer_matrix of three jittered variants of a pulse
    (tests/test_parallel.py's batch) equals the single evaluations within
    1e-13, and JAX's batched call likewise; a spectrum given as a tensor,
    or a memory budget of one segment per chunk of the second-order
    terms, gives the same result within 1e-15."""
    jp, p = _pair(3, 4, 50 + KINDS.index(kind))
    omega = np.geomspace(0.1, 10, 24)
    spectrum = _spectrum(kind, omega)
    jarr, arr = _arrays(jp)
    scales = np.array([1.0, 1.01, 0.99])
    batch = arr._replace(
        c_coeffs=torch.as_tensor(scales[:, None, None]) * arr.c_coeffs,
        n_coeffs=arr.n_coeffs.expand(3, -1, -1),
        dt=arr.dt.expand(3, -1))
    jbatch = jfunctional.PulseArrays(
        jarr.c_opers, np.asarray(batch.c_coeffs), jarr.n_opers,
        np.asarray(batch.n_coeffs), np.asarray(batch.dt), jarr.basis)
    got = functional.batched_error_transfer_matrix(
        batch, spectrum, omega, p.basis, second_order=True)
    assert got.shape == (3, 9, 9)
    want = np.asarray(jfunctional.batched_error_transfer_matrix(
        jbatch, spectrum, omega, jp.basis, second_order=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    for b, scale in enumerate(scales):
        single = functional.error_transfer_matrix(
            arr._replace(c_coeffs=scale * arr.c_coeffs), spectrum, omega,
            p.basis, second_order=True)
        np.testing.assert_allclose(got[b].numpy(), single.numpy(), rtol=0,
                                   atol=1e-13)
    on_device = functional.batched_error_transfer_matrix(
        batch, torch.as_tensor(spectrum), torch.as_tensor(omega), p.basis,
        second_order=True)
    np.testing.assert_allclose(on_device.numpy(), got.numpy(), rtol=0,
                               atol=1e-15)
    chunked = functional._etm_core(batch, spectrum, torch.as_tensor(omega),
                                   p.basis, True, budget_bytes=1)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize('second_order', [False, True])
def test_functional_etm_through_the_basis(second_order):
    """Above 64 basis elements (d = 9, a GGM basis of 81) the functional
    and batched ETMs contract the cumulant function through the basis,
    as the object path does, instead of with the n^4 trace combos: each
    row within 1e-15 of the object path's ETM (the same contraction,
    batched otherwise), first and second order."""
    jp, p = _pair(9, 2, 60)
    omega = np.geomspace(0.1, 10, 16)
    spectrum = 1e-3 / omega
    _, arr = _arrays(jp)
    assert len(p.basis) == 81
    want = fft.error_transfer_matrix(p, spectrum, omega,
                                     second_order=second_order)
    got = functional.error_transfer_matrix(arr, spectrum, omega, p.basis,
                                           second_order)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-15)
    batch = arr._replace(c_coeffs=arr.c_coeffs.expand(2, -1, -1),
                         n_coeffs=arr.n_coeffs.expand(2, -1, -1),
                         dt=arr.dt.expand(2, -1))
    got = functional.batched_error_transfer_matrix(batch, spectrum, omega,
                                                   p.basis, second_order)
    for row in got:
        np.testing.assert_allclose(row.numpy(), want.numpy(), rtol=0,
                                   atol=1e-15)


N_OMEGA_FLAGSHIP = 64


def test_flagship_etm_matches_jax():
    """The first-order ETM of the QFT pulse at 64 frequencies (n_b = 256:
    the contraction through the basis) against the JAX package's
    calculate_cumulant_function(decay_amplitudes=Gamma) ->
    error_transfer_matrix(cumulant_function=K), with Gamma built in
    numpy from JAX's native control matrix and trapezoid weights (its
    integrand route would allocate over 1 GB): within 1e-13 (measured
    3.7e-15).  -tr K / d^2 matches ff.infidelity within 1e-12 relative
    (measured 4e-17), and the ETM is completely positive."""
    port = fft.qft_pulse_sequence(4, device='cpu')
    jp = ff.PulseSequence.from_arrays(
        *(getattr(port, f) for f in convert.PULSE_FIELDS))
    omega = np.geomspace(1e-2, 1e2, N_OMEGA_FLAGSHIP)
    spectrum = 1e-4 / omega
    got = fft.error_transfer_matrix(port, spectrum, omega)
    assert got.shape == (256, 256) and got.dtype == torch.float64

    ctrl = jp.get_control_matrix(omega).to_numpy()
    weights = spectrum * np.asarray(jnumeric.trapezoid_weights(omega)) \
        / (2 * np.pi)
    gamma = np.einsum('ako,o,alo->akl', ctrl.conj(), weights, ctrl).real
    k_jax = jnumeric.calculate_cumulant_function(jp, decay_amplitudes=gamma)
    want = np.asarray(ff.error_transfer_matrix(cumulant_function=k_jax))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)

    k = numeric.calculate_cumulant_function(port, spectrum, omega)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_jax), rtol=0,
                               atol=1e-12 * np.abs(k_jax).max())
    infid = np.asarray(ff.infidelity(jp, spectrum, omega))
    from_trace = -np.einsum('aii->a', k.numpy()) / port.d**2
    np.testing.assert_allclose(from_trace, infid, rtol=0,
                               atol=1e-12 * infid.sum())
    assert liouville_is_CP(got, port.basis)


@pytest.mark.parametrize('n', [4, 16, 256])
def test_expm_matches_scipy(n):
    """The ETM's matrix exponential against scipy.linalg.expm within
    1e-15 relative for 1-norms up to ~0.5, where the cumulant functions
    of weak noise lie, and 1e-13 up to ~5.  torch.linalg.matrix_exp
    is off by 1.6e-12 at a 1-norm of 0.046 (d = 4) on the CPU, which
    the ETM parity of 1e-13 does not allow."""
    sla = pytest.importorskip('scipy.linalg')
    rng = np.random.default_rng(n)
    for scale in (1e-4, 1e-3, 7e-3, 2e-2, 3e-2, 1e-1, 1.0):
        a = rng.normal(size=(2, n, n)) * scale / np.sqrt(n)
        got = numeric._expm(torch.as_tensor(a)).numpy()
        for b in range(2):
            want = sla.expm(a[b])
            norm = np.abs(a[b]).sum(0).max()
            bound = 1e-15 if norm <= 0.5 else 1e-13
            np.testing.assert_allclose(got[b], want, rtol=0,
                                       atol=bound * np.abs(want).max())


def _degenerate_pulse():
    """A d = 2 pulse (Pauli basis, X/2 and Y/2 controls, X/2 and Z/2
    noise, 4 segments) whose segment 1 has zero amplitude: H = 0 there,
    one doubly degenerate eigenspace; its arrays and basis."""
    rng = np.random.default_rng(12)
    X, Y, Z = fft.util.paulis[1:]
    coeffs = rng.standard_normal((2, 4))
    coeffs[:, 1] = 0.0
    pulse = fft.PulseSequence(
        [[X / 2, coeffs[0], 'X'], [Y / 2, coeffs[1], 'Y']],
        [[X / 2, np.ones(4), 'X'], [Z / 2, rng.random(4), 'Z']],
        1 - 0.5 * rng.random(4), basis=fft.Basis.pauli(1), device='cpu')
    return functional.make_pulse_arrays(pulse), pulse.basis


@pytest.mark.parametrize('entry', ['functional', 'batched'])
@pytest.mark.parametrize('second_order', [False, True])
def test_etm_gradient_at_degenerate_spectrum(second_order, entry):
    """Autograd through the functional ETMs at a degenerate Hamiltonian
    (the H = 0 segment of :func:`_degenerate_pulse`, 64 frequencies).
    First order: the directional derivative of a weighted sum of the ETM
    along a seeded direction in c_coeffs is within 1e-6 relative of
    central differences at h = 1e-6 (measured 2e-10 to 1.3e-8), for a
    diagonal spectrum (the folded decay amplitudes) and a cross-spectrum
    (the integrand), both 30 times those of the tests above so that the
    differences' rounding (~eps/h of the ETM's unit entries) stays far
    below the bound; without the degenerate-eigenspace term of the
    control matrix it is 7.5e-2 to 1.37 off.
    Second order: a call through which a gradient can reach the
    degenerate H raises ValueError (the shifts' terms inside degenerate
    eigenspaces have no backward).  The forward values with requires_grad
    equal those without, bit for bit."""
    p, basis = _degenerate_pulse()
    if entry == 'batched':
        scales = torch.tensor([1.0, 0.9])[:, None, None]
        p = p._replace(c_coeffs=scales * p.c_coeffs,
                       n_coeffs=p.n_coeffs.expand(2, -1, -1),
                       dt=p.dt.expand(2, -1))
        call = functional.batched_error_transfer_matrix
    else:
        call = functional.error_transfer_matrix
    omega = np.geomspace(0.1, 30, 64)
    rng = np.random.default_rng(13)
    direction = torch.tensor(rng.standard_normal(p.c_coeffs.shape))
    for kind in ('shared', 'cross'):
        spectrum = 30 * _spectrum(kind, omega)
        weights = torch.tensor(rng.standard_normal(
            (*p.c_coeffs.shape[:-2], 4, 4)))

        def loss(c):
            return (call(p._replace(c_coeffs=c), spectrum, omega, basis,
                         second_order) * weights).sum()

        plain = call(p, spectrum, omega, basis, second_order)
        c = p.c_coeffs.clone().requires_grad_(True)
        with torch.no_grad():
            assert torch.equal(call(p._replace(c_coeffs=c), spectrum, omega,
                                    basis, second_order), plain)
        if second_order:
            with pytest.raises(ValueError, match='degenerate'):
                loss(c)
            continue
        assert torch.equal(call(p._replace(c_coeffs=c), spectrum, omega,
                                basis).detach(), plain)
        grad, = torch.autograd.grad(loss(c), c)
        h = 1e-6
        with torch.no_grad():
            central = (loss(p.c_coeffs + h * direction)
                       - loss(p.c_coeffs - h * direction)) / (2 * h)
        got = (grad * direction).sum()
        assert abs(got - central) <= 1e-6 * abs(central), (kind, got,
                                                          central)
