"""The PyTorch port's numerical kernels (filter_functions_tpu_torch.numeric,
.util, .config) against the JAX package's, on the 4-qubit QFT pulse and
on small random inputs.

Eigenvectors are compared only through quantities that do not depend on
their gauge: LAPACK's eigh is free to pick any phase per column and any
basis of a degenerate subspace.  Where a test needs equal eigenvectors
it feeds JAX's eigendecomposition to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from filter_functions_tpu import numeric as jnumeric
from filter_functions_tpu import util as jutil
from filter_functions_tpu.cplx import C
from filter_functions_tpu_torch import config, numeric, util

N_OMEGA = 1000


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(c):
    """numpy complex array of a split-complex JAX value."""
    return np.asarray(c.re) + 1j * np.asarray(c.im)


@pytest.fixture(scope='module')
def qft():
    """The flagship pulse as numpy arrays, its Hamiltonian and omega."""
    p = jax.tree.map(np.asarray, __graft_entry__._qft_pulse_arrays(4))
    c_opers = p.c_opers.re + 1j * p.c_opers.im
    ham = np.einsum('jmn,jg->gmn', c_opers, p.c_coeffs)
    omega = np.geomspace(1e-2, 1e2, N_OMEGA)
    return p, ham, omega


@pytest.fixture(scope='module')
def jax_k0(qft):
    """JAX's K0 of the flagship Hamiltonian: (eigvals, eigvecs,
    propagators) as numpy."""
    p, ham, _ = qft
    w, v, q = jnumeric._diagonalize_jit(C(jnp.asarray(ham.real),
                                          jnp.asarray(ham.imag)),
                                        jnp.asarray(p.dt))
    return np.asarray(w), _np(v), _np(q)


@pytest.mark.parametrize('source', ['qft', 'random'])
def test_diagonalize_matches_jax(source, qft):
    """K0: eigenvalues, V diag(w) V^dag and the cumulative propagators
    agree with JAX within 1e-12 (LAPACK rounding of a d = 16 eigh with
    eigenvalues of order 10, and 13 chained unitary products)."""
    if source == 'qft':
        p, ham, _ = qft
        dt = p.dt
    else:
        rng = np.random.default_rng(40)
        a = rng.standard_normal((5, 6, 6)) + 1j * rng.standard_normal(
            (5, 6, 6))
        ham = a + a.conj().swapaxes(-1, -2)
        dt = 0.2 + rng.random(5)
    w, v, q = jnumeric._diagonalize_jit(C(jnp.asarray(ham.real),
                                          jnp.asarray(ham.imag)),
                                        jnp.asarray(dt))
    w, v, q = np.asarray(w), _np(v), _np(q)
    gw, gv, gq = (x.numpy() for x in numeric.diagonalize(_t(ham), _t(dt)))
    assert gq.shape == (len(dt) + 1,) + ham.shape[1:]
    np.testing.assert_allclose(gw, w, rtol=0, atol=1e-12)
    rebuilt = (gv * gw[:, None, :]) @ gv.conj().swapaxes(-1, -2)
    np.testing.assert_allclose(rebuilt, (v * w[:, None, :])
                               @ v.conj().swapaxes(-1, -2), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(rebuilt, ham, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gq, q, rtol=0, atol=1e-12)


def test_diagonalize_splits_large_batches(monkeypatch):
    """Above numeric._EIGH_MAX_BATCH matrices the eigendecomposition runs
    in pieces (cuSOLVER refuses about 3e4 matrices in one batched call);
    values equal the unsplit ones exactly; the gradient within 1e-14
    (1.1e-16 measured: the pieces' eigenvectors are laid out row-major,
    so the backward's products round differently)."""
    rng = np.random.default_rng(41)
    a = rng.standard_normal((3, 7, 2, 2)) + 1j * rng.standard_normal(
        (3, 7, 2, 2))
    ham = _t(a + a.conj().swapaxes(-1, -2))
    dt = _t(0.2 + rng.random((3, 7)))

    def run():
        h = ham.clone().requires_grad_(True)
        out = numeric.diagonalize(h, dt)
        grad, = torch.autograd.grad(out[2].real.sum() + out[0].sum(), h)
        return [x.detach() for x in out] + [grad]

    want = run()
    monkeypatch.setattr(numeric, '_EIGH_MAX_BATCH', 4)
    *got, got_grad = run()
    for x, ref in zip(got, want):
        assert x.shape == ref.shape
        assert torch.equal(x, ref)
    torch.testing.assert_close(got_grad, want[-1], rtol=0, atol=1e-14)


@pytest.fixture(scope='module')
def step_terms(qft, jax_k0):
    """Both packages' step terms of the flagship pulse, fed JAX's
    eigendecomposition."""
    p, _, omega = qft
    w, v, q = jax_k0
    t = np.concatenate([[0.0], np.cumsum(p.dt)])
    want = jnumeric._ctrlmat_step_terms(
        jnp.asarray(w), C(jnp.asarray(v.real), jnp.asarray(v.imag)),
        C(jnp.asarray(q[:-1].real), jnp.asarray(q[:-1].imag)),
        jnp.asarray(omega), p.basis, p.n_opers, jnp.asarray(p.n_coeffs),
        jnp.asarray(p.dt), jnp.asarray(t[:-1]))
    got = numeric._ctrlmat_step_terms(
        _t(w), _t(v), _t(q[:-1]), _t(omega),
        _t(p.basis.re + 1j * p.basis.im),
        _t(p.n_opers.re + 1j * p.n_opers.im), _t(p.n_coeffs), _t(p.dt),
        _t(t[:-1]))
    return [x.numpy() for x in got], [_np(x) for x in want]


STEP_TERMS = ['eigvecs_propagated', 'n_opers_transformed',
              'basis_transformed', 'phase_factors', 'integral']


@pytest.mark.parametrize('index', range(5), ids=STEP_TERMS)
def test_step_terms_match_jax(index, step_terms):
    """K4 step terms, fed JAX's eigendecomposition, agree within 1e-12
    of each term's largest magnitude: the same products in another
    summation order (matmul against einsum)."""
    got, want = step_terms
    g, w = got[index], want[index]
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()


def test_first_order_integral_taylor_branch_matches_jax():
    """_frac_from_trig on both sides of |u dt| = 0.05, including u = 0
    exactly, against JAX within 1e-15 relative (the same polynomial and
    division, rounded alike)."""
    rng = np.random.default_rng(41)
    u = np.concatenate([[0.0, 1e-300, -1e-12], rng.standard_normal(200)
                        * np.exp(rng.uniform(-12, 3, 200))])
    dt = 0.7
    sin_u, cos_u = np.sin(u * dt), np.cos(u * dt)
    want = jnumeric._frac_from_trig(jnp.asarray(u), jnp.asarray(sin_u),
                                    jnp.asarray(cos_u), dt)
    got = numeric._frac_from_trig(_t(u), _t(sin_u), _t(cos_u), dt)
    for g, w in zip(got, (want.re, want.im)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15,
                                   atol=0)
    assert got[1][0].item() == dt and got[0][0].item() == 0.0


def test_adot_and_integrate_match_jax():
    """util.adot (sequential product) and util.integrate (trapezoid)
    against JAX: 1e-13 on products of 13 unitaries, 1e-15 relative on
    the trapezoid sum."""
    rng = np.random.default_rng(42)
    a = rng.standard_normal((13, 8, 8)) + 1j * rng.standard_normal(
        (13, 8, 8))
    u, _ = np.linalg.qr(a)
    want = _np(jutil.adot(C(jnp.asarray(u.real), jnp.asarray(u.imag))))
    np.testing.assert_allclose(util.adot(_t(u)).numpy(), want, rtol=0,
                               atol=1e-13)
    x = np.geomspace(1e-2, 1e2, 300)
    f = rng.random((3, 300)) / x
    np.testing.assert_allclose(util.integrate(_t(f), _t(x)).numpy(),
                               np.asarray(jutil.integrate(jnp.asarray(f),
                                                          jnp.asarray(x))),
                               rtol=1e-15, atol=0)


def test_native_contraction_matches_jax():
    """_ctrlmat_contract, native route: one complex128 product P @ D
    against JAX's einsum 'go,jgmn,gomn,gknm->jko' on random step terms,
    within 1e-13 of the result's scale (sums of G d^2 = 48 terms in
    another order)."""
    rng = np.random.default_rng(43)
    G, n_w, d, n_nops, n_b = 3, 7, 4, 2, 16
    cplx = lambda *s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    n_t, integral = cplx(n_nops, G, d, d), cplx(G, n_w, d, d)
    b_t, ph = cplx(G, n_b, d, d), cplx(G, n_w)
    jc = lambda x: C(jnp.asarray(x.real), jnp.asarray(x.imag))
    want = _np(jnumeric._ctrlmat_contract(jc(n_t), jc(integral), jc(b_t),
                                          jc(ph)))
    got, ratio = numeric._ctrlmat_contract(_t(n_t), _t(integral), _t(b_t),
                                           _t(ph), 'stat', 'native')
    assert got.shape == (n_nops, n_b, n_w)
    assert ratio.item() == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-13 * np.abs(want).max())


def test_deep_quant_ratio_matches_jax():
    """The escalation statistic against JAX on the same float32 P and
    random contraction output, within 1e-5 relative: both sum in
    float32, in another order (K = 3328 terms)."""
    rng = np.random.default_rng(44)
    n_w, K, J, Cb = 32, 3328, 3, 16
    p_re, p_im = (rng.standard_normal((n_w, K)).astype(np.float32)
                  for _ in range(2))
    b = rng.standard_normal((K, J)) + 1j * rng.standard_normal((K, J))
    c = rng.standard_normal((K, Cb)) + 1j * rng.standard_normal((K, Cb))
    out = rng.standard_normal((2, n_w, J * Cb))
    out[:, 3] = 0.0
    jc = lambda x: C(jnp.asarray(x.real), jnp.asarray(x.imag))
    want = jnumeric._deep_quant_ratio(
        jnp.asarray(out[0]), jnp.asarray(out[1]),
        C(jnp.asarray(p_re), jnp.asarray(p_im)), jc(b), jc(c), J, Cb)
    got = numeric._deep_quant_ratio(_t(out[0]), _t(out[1]), _t(p_re),
                                    _t(p_im), _t(b), _t(c), J, Cb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_contraction_mode_and_deep_regime():
    """contract=None resolves by device, as config.contraction_mode
    resolves by backend; the flagship K = 3328 is deep, K = 64 (d = 4,
    G = 4) is not."""
    assert config.contraction_mode(torch.device('cpu')) == 'native'
    assert config.contraction_mode(torch.device('cuda', 0)) == 'ozaki'
    assert config.contraction_mode('cpu', 'ozaki') == 'ozaki'
    with pytest.raises(ValueError):
        config.contraction_mode('cpu', 'bf16')
    assert numeric._is_deep(13 * 16 * 16)
    assert not numeric._is_deep(4 * 4 * 4)
