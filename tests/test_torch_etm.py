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
from torch_testutil import fft_cpu, record_lattice_rows

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


def _degenerate_pulse(eps=0.0):
    """A d = 2 pulse (Pauli basis, X/2 and Y/2 controls, X/2 and Z/2
    noise, 4 segments) whose segment 1 has zero amplitude: H = 0 there,
    one doubly degenerate eigenspace; with *eps* its X amplitude there is
    *eps*, which splits the eigenspace by *eps*.  Its arrays and basis."""
    rng = np.random.default_rng(12)
    X, Y, Z = fft.util.paulis[1:]
    coeffs = rng.standard_normal((2, 4))
    coeffs[:, 1] = 0.0
    coeffs[0, 1] = eps
    pulse = fft.PulseSequence(
        [[X / 2, coeffs[0], 'X'], [Y / 2, coeffs[1], 'Y']],
        [[X / 2, np.ones(4), 'X'], [Z / 2, rng.random(4), 'Z']],
        1 - 0.5 * rng.random(4), basis=fft.Basis.pauli(1), device='cpu')
    return functional.make_pulse_arrays(pulse), pulse.basis


def _partially_degenerate_pulse():
    """A d = 4 pulse (two-qubit Pauli basis, XI/2, IY/2 and ZZ/4
    controls, ZI/2 and IX/2 noise, 4 segments) whose segment 2 is driven
    by XI alone: two twofold eigenvalues there, the other segments
    non-degenerate.  Its arrays and basis."""
    rng = np.random.default_rng(15)
    I, X, Y, Z = fft.util.paulis
    tensor = fft.util.tensor
    coeffs = rng.standard_normal((3, 4))
    coeffs[1:, 2] = 0.0
    pulse = fft.PulseSequence(
        [[tensor(X, I) / 2, coeffs[0], 'XI'],
         [tensor(I, Y) / 2, coeffs[1], 'IY'],
         [tensor(Z, Z) / 4, coeffs[2], 'ZZ']],
        [[tensor(Z, I) / 2, np.ones(4), 'ZI'],
         [tensor(I, X) / 2, rng.random(4), 'IX']],
        1 - 0.5 * rng.random(4), basis=fft.Basis.pauli(2), device='cpu')
    return functional.make_pulse_arrays(pulse), pulse.basis


def _batched(p):
    """A batch of two: *p* and *p* with its controls scaled by 0.9."""
    scales = torch.tensor([1.0, 0.9])[:, None, None]
    return p._replace(c_coeffs=scales * p.c_coeffs,
                      n_coeffs=p.n_coeffs.expand(2, -1, -1),
                      dt=p.dt.expand(2, -1))


def _etm_loss(p, basis, spectrum, omega, second_order, weights,
              budget_bytes=None):
    """A weighted sum of the ETM(s) of *p* as a function of c_coeffs:
    ``error_transfer_matrix`` of a pulse, ``batched_error_transfer_matrix``
    of a batch, ``_etm_core`` (their body) with a memory budget."""
    call = (functional.batched_error_transfer_matrix if p.c_coeffs.ndim == 3
            else functional.error_transfer_matrix)

    def loss(c):
        q = p._replace(c_coeffs=c)
        if budget_bytes is None:
            etm = call(q, spectrum, omega, basis, second_order)
        else:
            etm = functional._etm_core(q, spectrum, torch.as_tensor(omega),
                                       basis, second_order, budget_bytes)
        return (etm * weights).sum()
    return loss


def _etm_grad(loss, c_coeffs):
    c = c_coeffs.clone().requires_grad_(True)
    grad, = torch.autograd.grad(loss(c), c)
    return grad


def _against_central(loss, c_coeffs, direction, h=1e-6):
    """(autograd directional derivative, central difference at *h*)."""
    got = (_etm_grad(loss, c_coeffs) * direction).sum()
    with torch.no_grad():
        central = (loss(c_coeffs + h * direction)
                   - loss(c_coeffs - h * direction)) / (2 * h)
    return got, central


@pytest.mark.parametrize('entry', ['functional', 'batched'])
@pytest.mark.parametrize('second_order', [False, True])
def test_etm_gradient_at_degenerate_spectrum(second_order, entry):
    """Autograd through the functional ETMs at a degenerate Hamiltonian
    (the H = 0 segment of :func:`_degenerate_pulse`, 64 frequencies): the
    directional derivative of a weighted sum of the ETM along a seeded
    direction in c_coeffs is within 1e-6 relative of central differences
    at h = 1e-6, for a diagonal spectrum (the folded decay amplitudes and
    shifts) and a cross-spectrum (the integrand and F^(2) through
    ``_second_order_total``), both 30 times those of the tests above so
    that the differences' rounding (~eps/h of the ETM's unit entries)
    stays far below the bound.  Measured: first order 2e-10 to 1.3e-8,
    7.5e-2 to 1.37 off without the degenerate-eigenspace term of the
    control matrix; second order 7e-12 to 2.3e-9, 0.34 to 0.52 (of the
    largest gradient entry) off without the degenerate-eigenspace terms
    of the per-step control matrices and of the incomplete steps.  The
    forward values with requires_grad equal those without, bit for
    bit."""
    p, basis = _degenerate_pulse()
    if entry == 'batched':
        p = _batched(p)
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
        plain = call(p, spectrum, omega, basis, second_order)
        c = p.c_coeffs.clone().requires_grad_(True)
        with torch.no_grad():
            assert torch.equal(call(p._replace(c_coeffs=c), spectrum, omega,
                                    basis, second_order), plain)
        assert torch.equal(call(p._replace(c_coeffs=c), spectrum, omega,
                                basis, second_order).detach(), plain)
        got, central = _against_central(
            _etm_loss(p, basis, spectrum, omega, second_order, weights),
            p.c_coeffs, direction)
        assert abs(got - central) <= 1e-6 * abs(central), (kind, got,
                                                          central)


@pytest.mark.parametrize('kind', ['shared', 'cross'])
def test_second_order_etm_gradient_lifted_degeneracy(kind):
    """An oracle independent of finite differences: split the H = 0
    segment of :func:`_degenerate_pulse` by eps = 1e-4, 1e-5, 1e-6 (gaps
    far above ``numeric._DEGENERATE_GAP``, so plain autograd is exact
    there and no degenerate-eigenspace term is built); the second-order
    gradient there approaches the one at eps = 0 linearly: |g(eps) -
    g(0)| / eps (relative to the largest entry of g(0)) is the same at the
    three gaps within 1e-3 relative (measured 2.3e-5: the eps^2 term),
    0.44 (shared) and 0.33 (cross).  A gradient without the new terms
    would stay ~0.5 away."""
    omega = np.geomspace(0.1, 30, 64)
    rng = np.random.default_rng(13)
    weights = torch.tensor(rng.standard_normal((4, 4)))
    spectrum = 30 * _spectrum(kind, omega)

    def grad(eps):
        p, basis = _degenerate_pulse(eps)
        return _etm_grad(_etm_loss(p, basis, spectrum, omega, True, weights),
                         p.c_coeffs)

    at_zero = grad(0.0)
    scale = at_zero.abs().max()
    slopes = [((grad(eps) - at_zero).abs().max() / scale / eps).item()
              for eps in (1e-4, 1e-5, 1e-6)]
    assert 0.1 < slopes[0] < 1.0, slopes
    np.testing.assert_allclose(slopes, slopes[0], rtol=1e-3, atol=0)


@pytest.mark.parametrize('kind', ['shared', 'cross'])
def test_second_order_etm_gradient_partial_degeneracy(kind):
    """d = 4 with two twofold eigenvalues on one segment
    (:func:`_partially_degenerate_pulse`): the second-order directional
    derivative, both entry points, within 1e-6 relative of central
    differences at h = 1e-6 (measured 3.4e-10 to 5.0e-9)."""
    p, basis = _partially_degenerate_pulse()
    _, degenerate = numeric._eig_gaps(torch.linalg.eigvalsh(
        torch.einsum('jmn,jg->gmn', p.c_opers, p.c_coeffs.to(torch.cdouble))))
    assert degenerate.sum((-1, -2)).tolist() == [4, 4, 8, 4]
    omega = np.geomspace(0.1, 30, 48)
    rng = np.random.default_rng(16)
    for batch in (p, _batched(p)):
        direction = torch.tensor(rng.standard_normal(batch.c_coeffs.shape))
        weights = torch.tensor(rng.standard_normal(
            (*batch.c_coeffs.shape[:-2], 16, 16)))
        got, central = _against_central(
            _etm_loss(batch, basis, 30 * _spectrum(kind, omega), omega, True,
                      weights), batch.c_coeffs, direction)
        assert abs(got - central) <= 1e-6 * abs(central), (got, central)


@pytest.mark.parametrize('kind', ['shared', 'cross'])
def test_second_order_etm_gradient_in_segment_chunks(kind):
    """A memory budget of one byte runs the shifts, F^(2) and the
    backward of their degenerate-eigenspace term in chunks of one
    segment: the second-order gradient at :func:`_degenerate_pulse` is
    that of one chunk within 1e-13 of its largest entry."""
    p, basis = _degenerate_pulse()
    omega = np.geomspace(0.1, 30, 64)
    eigvals = torch.linalg.eigvalsh(torch.einsum(
        'jmn,jg->gmn', p.c_opers, p.c_coeffs.to(torch.cdouble)))
    assert numeric._factored_chunk(eigvals, len(omega), 0, 1) == 1
    assert numeric._factored_chunk(eigvals, len(omega), 0) == 4
    weights = torch.tensor(np.random.default_rng(17).standard_normal((4, 4)))
    spectrum = 30 * _spectrum(kind, omega)
    whole, chunked = (
        _etm_grad(_etm_loss(p, basis, spectrum, omega, True, weights,
                            budget_bytes), p.c_coeffs)
        for budget_bytes in (None, 1))
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-13 * whole.abs().max().item())


@pytest.mark.parametrize('entry', ['functional', 'batched'])
@pytest.mark.parametrize('make', [_degenerate_pulse,
                                  _partially_degenerate_pulse],
                         ids=['degenerate', 'partial'])
def test_second_order_etm_gradient_one_row_equals_equal_rows(make, entry,
                                                             monkeypatch):
    """A spectrum shared by both noise operators, given 1-d (one weighted
    K2 lattice for both, in the shifts and in the backward of their
    degenerate-eigenspace term) and as two materialised equal rows (one
    lattice each): at the degenerate pulses above, the second-order ETM
    within 1e-13 and its gradient within 1e-13 of its largest entry."""
    p, basis = make()
    if entry == 'batched':
        p = _batched(p)
    omega = np.geomspace(0.1, 30, 64)
    shared = 30 * _spectrum('shared', omega)
    rng = np.random.default_rng(18)
    weights = torch.tensor(rng.standard_normal(
        (*p.c_coeffs.shape[:-2], len(basis), len(basis))))
    built = record_lattice_rows(monkeypatch)
    etms, grads = [], []
    for spectrum, n_rows in ((shared, 1), (np.tile(shared, (2, 1)), 2)):
        built.clear()
        etms.append(functional._etm_core(p, spectrum, torch.as_tensor(omega),
                                         basis, True))
        grads.append(_etm_grad(
            _etm_loss(p, basis, spectrum, omega, True, weights), p.c_coeffs))
        assert built and set(built) == {n_rows}
    np.testing.assert_allclose(etms[0].numpy(), etms[1].numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0,
                               atol=1e-13 * grads[1].abs().max().item())


# -----------------------------------------------------------------------------
# Cross-spectra as real profiles with mixing factors
# -----------------------------------------------------------------------------
def _cross_spectrum(kind, omega):
    """A Hermitian cross-spectrum of three noise operators, (3, 3, n_w),
    and the number of real profiles it has: 'separable', C_ab 1e-3 /
    omega with C real, symmetric and positive definite (r = 1);
    'two_profiles', that plus a Lorentzian shared by two operators (r =
    2); 'complex', C complex and Hermitian on the 1/f profile plus a
    complex Hermitian Lorentzian part (r = 2: the real and imaginary
    parts of each entry lie on the two profiles)."""
    one_f = 1e-3 / omega
    lorentz = 1e-3 * 400 / (omega ** 2 + 400)
    c = np.array([[1.0, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 1.0]])
    if kind == 'separable':
        return c[:, :, None] * one_f, 1
    d = np.array([[0.0, 0.0, 0.0], [0.0, 2.0, 0.7], [0.0, 0.7, 1.5]])
    if kind == 'two_profiles':
        return c[:, :, None] * one_f + d[:, :, None] * lorentz, 2
    h = c + 1j * np.array([[0, 0.3, -0.2], [-0.3, 0, 0.1], [0.2, -0.1, 0]])
    e = d + 1j * np.array([[0, 0, 0], [0, 0, 0.4], [0, -0.4, 0]])
    return h[:, :, None] * one_f + e[:, :, None] * lorentz, 2


CROSS_KINDS = ['separable', 'two_profiles', 'complex']


def _cross_pair(seed):
    """(JAX pulse, port pulse) of d = 4 with 3 noise operators and 4
    segments (the 16-element GGM basis)."""
    arrays = rand_pulse_arrays(4, 4, 3, 3,
                               local_rng=np.random.default_rng(seed))
    return make_pulse(arrays), make_pulse(arrays, cls=fft_cpu)


@pytest.mark.parametrize('kind', CROSS_KINDS)
def test_cross_route_matches_f2_and_jax(kind, monkeypatch):
    """The functional ETM of a cross-spectrum (profiles and mixing,
    ``numeric._spectrum_profiles``) against the port's F^(2) route (the
    object path: the (a, b, k, l, w) integrand and F^(2)) and against
    the JAX package's functional error_transfer_matrix, first and second
    order, within 1e-13, with one weighted lattice per profile."""
    jp, p = _cross_pair(70 + CROSS_KINDS.index(kind))
    omega = np.geomspace(0.1, 10, 24)
    spectrum, n_profiles = _cross_spectrum(kind, omega)
    jarr, arr = _arrays(jp)
    prof = numeric._spectrum_profiles(torch.as_tensor(spectrum),
                                      torch.as_tensor(omega), 3)
    assert prof.weights.shape == (n_profiles, len(omega))
    assert prof.corr.tolist() == [0, 1, 2]
    built = record_lattice_rows(monkeypatch)
    for second in (False, True):
        built.clear()
        got = functional.error_transfer_matrix(arr, spectrum, omega, p.basis,
                                               second_order=second)
        assert set(built) == ({n_profiles} if second else set())
        obj = fft.error_transfer_matrix(p, spectrum, omega,
                                        second_order=second)
        np.testing.assert_allclose(got.numpy(), obj.numpy(), rtol=0,
                                   atol=1e-13)
        want = np.asarray(jfunctional.error_transfer_matrix(
            jarr, spectrum, omega, jp.basis, second_order=second))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


def _random_spectrum(rng, n, n_w, rank, complex_):
    """A Hermitian (n, n, n_w) spectrum sum_r M_r s_r(w) with *rank*
    random positive profiles and random Hermitian factors."""
    s = rng.random((rank, n_w)) / np.linspace(0.1, 10, n_w)
    m = rng.standard_normal((rank, n, n))
    if complex_:
        m = m + 1j * rng.standard_normal((rank, n, n))
    m = (m + m.conj().transpose(0, 2, 1)) / 2
    return np.einsum('rab,ro->abo', m, s)


@pytest.mark.parametrize('kind', CROSS_KINDS + ['random_real',
                                                 'random_complex',
                                                 'diagonal_complex'])
def test_profiles_reproduce_the_spectrum(kind):
    """sum_r M^(r)_ab weights_r equals S_ab w_trapz / 2 pi within the
    stated tolerance, n_w eps of each row's 2-norm (a row: the real or
    imaginary part of one entry over the frequencies), and the diagonal
    weights are S_aa w_trapz / 2 pi likewise; random spectra of rank 3
    give three profiles, and a complex diagonal (2-d) spectrum, one
    profile, is read as its embedding.  The separable spectrum's one
    profile is its largest row itself, the diagonal's factors exactly 1
    (``pick``)."""
    rng = np.random.default_rng(71)
    n_w = 40
    omega = np.geomspace(0.1, 10, n_w)
    rank = 3
    if kind in CROSS_KINDS:
        spectrum, rank = _cross_spectrum(kind, omega)
    elif kind == 'diagonal_complex':
        spectrum = (1 + 0.5j) * np.outer([1.0, 2.0, 3.0], 1e-3 / omega)
        rank = 1
    else:
        spectrum = _random_spectrum(rng, 4, n_w, 3, kind == 'random_complex')
    n = spectrum.shape[0]
    prof = numeric._spectrum_profiles(torch.as_tensor(spectrum),
                                      torch.as_tensor(omega), n)
    weights = prof.weights.numpy()
    assert weights.shape == (rank, n_w)
    full = spectrum if spectrum.ndim == 3 else np.einsum(
        'ab,bo->abo', np.eye(n), spectrum)
    want = full * numeric.trapezoid_weights(torch.as_tensor(omega)).numpy() \
        / (2 * np.pi)
    got = np.einsum('rab,ro->abo', prof.factors, weights)
    tol = n_w * np.finfo(float).eps
    for part in (np.real, np.imag):
        norms = np.linalg.norm(part(want), axis=-1, keepdims=True)
        assert (np.abs(part(got) - part(want)) <= tol * norms).all()
    diag = np.einsum('aao->ao', want)
    got_diag = prof.diagonal.numpy()
    assert got_diag.shape[0] in (1, n)
    np.testing.assert_allclose(np.broadcast_to(got_diag, diag.shape), diag,
                               rtol=0, atol=tol * np.abs(diag).max())
    if kind == 'separable':
        assert prof.pick == 0 and prof.diag_factors is None
        assert torch.equal(prof.weights[0], torch.as_tensor(want[0, 0]))


def test_profiles_check_that_the_spectrum_is_hermitian():
    """A cross-spectrum that is not Hermitian raises as
    util.parse_spectrum does, from the one read of the profiles."""
    omega = np.geomspace(0.1, 10, 8)
    spectrum, _ = _cross_spectrum('separable', omega)
    spectrum[0, 1] *= 2
    with pytest.raises(ValueError, match='not Hermitian'):
        numeric._spectrum_profiles(torch.as_tensor(spectrum),
                                   torch.as_tensor(omega), 3)


@pytest.mark.parametrize('rows', ['shared', 'per_operator'])
def test_diagonal_cross_spectrum_equals_the_diagonal_route(rows):
    """A 3-d spectrum whose entries off the diagonal are zero takes the
    profile route (no operator correlated) and gives the diagonal
    route's ETM, first and second order, within 1e-14."""
    _, p = _cross_pair(72)
    arr = functional.make_pulse_arrays(p)
    omega = torch.as_tensor(np.geomspace(0.1, 10, 24))
    amplitudes = [1.0] * 3 if rows == 'shared' else [1.0, 0.5, 2.0]
    diagonal = torch.outer(torch.tensor(amplitudes), 1e-3 / omega)
    cross = torch.diag_embed(diagonal.T).movedim(0, -1)
    assert not len(numeric._spectrum_profiles(cross, omega, 3).corr)
    for second in (False, True):
        want = functional.error_transfer_matrix(arr, diagonal, omega,
                                                p.basis, second)
        got = functional.error_transfer_matrix(arr, cross, omega, p.basis,
                                               second)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-14)


@pytest.mark.parametrize('kind', CROSS_KINDS)
def test_cross_route_builds_no_integrand_and_no_f2(kind, monkeypatch):
    """Without a gradient, the ETM of a cross-spectrum calls neither the
    integrand (``numeric._get_integrand``) nor F^(2)
    (``numeric._second_order_total``), first or second order, batched
    or not."""
    _, p = _cross_pair(73)
    arr = functional.make_pulse_arrays(p)
    omega = np.geomspace(0.1, 10, 24)
    spectrum, _ = _cross_spectrum(kind, omega)

    def forbidden(*args, **kwargs):
        raise AssertionError('the cross route reached the F^(2) route')
    monkeypatch.setattr(numeric, '_get_integrand', forbidden)
    monkeypatch.setattr(numeric, '_second_order_total', forbidden)
    for second in (False, True):
        functional.error_transfer_matrix(arr, spectrum, omega, p.basis,
                                         second)
        functional.batched_error_transfer_matrix(_batched(arr), spectrum,
                                                 omega, p.basis, second)


@pytest.mark.parametrize('kind', ['two_profiles', 'complex'])
def test_cross_route_gradient_partial_degeneracy(kind):
    """Autograd through the profile route at the partially degenerate
    d = 4 pulse (two noise operators, so the first two rows and columns
    of the spectra above), two profiles, real and complex mixing
    factors: the second-order directional derivative within 1e-6
    relative of central differences at h = 1e-6, both entry points, as
    test_second_order_etm_gradient_partial_degeneracy holds the other
    spectra."""
    p, basis = _partially_degenerate_pulse()
    omega = np.geomspace(0.1, 30, 48)
    spectrum, _ = _cross_spectrum(kind, omega)
    spectrum = 30 * spectrum[1:, 1:]
    assert len(numeric._spectrum_profiles(torch.as_tensor(spectrum),
                                          torch.as_tensor(omega), 2
                                          ).weights) == 2
    rng = np.random.default_rng(74)
    for batch in (p, _batched(p)):
        direction = torch.tensor(rng.standard_normal(batch.c_coeffs.shape))
        weights = torch.tensor(rng.standard_normal(
            (*batch.c_coeffs.shape[:-2], 16, 16)))
        got, central = _against_central(
            _etm_loss(batch, basis, spectrum, omega, True, weights),
            batch.c_coeffs, direction)
        assert abs(got - central) <= 1e-6 * abs(central), (got, central)
