"""torch.autograd through the PyTorch port: the eigendecomposition's
backward (numeric._Eigh and the degenerate-eigenspace terms), the
factored Ozaki product's backward (ops.ozaki.ozaki_matmul_c_outer) and
the gradient of functional.batched_infidelity with respect to the
control coefficients, against jax.grad of the JAX package, the JAX
package's analytic derivative and central finite differences.

On degenerate spectra the JAX package's eigh derivative drops the
first-order terms inside each degenerate eigenspace, so jax.grad of its
infidelity misses them; the port restores them
(test_cut_flagship_gradient_matches_analytic_derivative).  Tolerances
are relative to the largest |value| unless marked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
from filter_functions_tpu import cplx
from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu import numeric as jnumeric
import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import functional, numeric
from filter_functions_tpu_torch.models import qft
from filter_functions_tpu_torch.ops import dword, ozaki
from testutil import rand_pulse_arrays
from torch_testutil import QFT_NPZ


def _t(x):
    return torch.tensor(np.asarray(x))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _grad(p, spectrum, omega, **kw):
    """Gradient of the summed batched infidelity of the port's pulses *p*
    with respect to their control coefficients."""
    cc = p.c_coeffs.clone().requires_grad_(True)
    infid = functional.batched_infidelity(p._replace(c_coeffs=cc), spectrum,
                                          omega, **kw)
    grad, = torch.autograd.grad(infid.sum(), cc)
    return grad


@pytest.fixture(scope='module')
def qft_arrays():
    """The flagship's host arrays (complex operators)."""
    with np.load(QFT_NPZ) as z:
        z = dict(z)
    return dict(c_opers=z['c_opers_re'] + 1j * z['c_opers_im'],
                n_opers=z['n_opers_re'] + 1j * z['n_opers_im'],
                c_coeffs=z['c_coeffs'], n_coeffs=z['n_coeffs'], dt=z['dt'])


# -----------------------------------------------------------------------------
# the eigendecomposition
# -----------------------------------------------------------------------------
def test_eigh_gradcheck_nondegenerate():
    """_Eigh's backward passes torch.autograd.gradcheck on a
    gauge-invariant function of a random non-degenerate d = 3 Hermitian
    matrix."""
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3)))
    a = _t(rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3)))

    def fn(x):
        w, v = numeric._Eigh.apply((x + x.mH) / 2)
        u = (v * torch.exp(-1j * w)) @ v.mH
        return (w**3).sum() + (a @ u).diagonal().sum().real

    assert torch.autograd.gradcheck(fn, (x.requires_grad_(True),))


def _segment_loss_parts(qft_arrays, g):
    """(c_opers, c (n_ctrl,), A) for segment *g* of the flagship: A is
    h^2 plus random entries between distinct eigenspaces of h only, so
    that the loss of :func:`test_eigh_on_degenerate_segment_matches_jax`
    has no first-order terms inside a degenerate eigenspace."""
    c_opers, c = qft_arrays['c_opers'], qft_arrays['c_coeffs'][:, g]
    h = np.einsum('jmn,j->mn', c_opers, c)
    w, v = np.linalg.eigh(h)
    rng = np.random.default_rng(g)
    r = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    a = h @ h
    for wa in np.unique(w):
        pa = v[:, w == wa] @ v[:, w == wa].conj().T
        a = a + pa @ r @ (np.eye(16) - pa)
    return c_opers, c, a


def test_eigh_on_degenerate_segment_matches_jax(qft_arrays):
    """On a flagship segment with 112 exactly degenerate ordered
    eigenvalue pairs, _Eigh's backward is finite and within 1e-12 of
    jax.grad through the JAX package's cplx.eigh (the transpose of its
    masked perturbation theory), and within 1e-7 of central finite
    differences."""
    c_opers, c, a = _segment_loss_parts(qft_arrays, 1)
    dt = 0.37

    def port_loss(c):
        h = torch.einsum('jmn,j->mn', _t(c_opers), c.to(torch.complex128))
        w, v = numeric._Eigh.apply(h)
        u = (v * torch.exp(-1j * dt * w)) @ v.mH
        return torch.sin(w).sum() + (_t(a) @ u).diagonal().sum().real

    def jax_loss(c):
        h = cplx.C(jnp.einsum('jmn,j->mn', c_opers.real, c),
                   jnp.einsum('jmn,j->mn', c_opers.imag, c))
        w, v = cplx.eigh(h)
        v = v.re + 1j * v.im
        u = (v * jnp.exp(-1j * dt * w)) @ v.conj().T
        return jnp.sin(w).sum() + jnp.trace(a @ u).real

    c_t = _t(c).requires_grad_(True)
    got, = torch.autograd.grad(port_loss(c_t), c_t)
    assert torch.isfinite(got).all()
    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(c)))
    assert _rel(got.numpy(), want) <= 1e-12
    fd = np.zeros_like(c)
    for j in range(len(c)):
        e = np.zeros_like(c)
        e[j] = 1e-6
        fd[j] = (port_loss(_t(c + e)) - port_loss(_t(c - e))).item() / 2e-6
    assert _rel(got.numpy(), fd) <= 1e-7


def test_first_order_integral_slope_matches_mpmath():
    """The slope of the first-order integral, dt^2 g'(phi dt), which the
    degenerate-eigenspace term of the control matrix takes: within 1e-14
    relative of 40-digit mpmath on both sides of the series threshold."""
    mpmath = pytest.importorskip('mpmath')
    mpmath.mp.dps = 40
    x = np.concatenate([np.linspace(-3, 3, 601), [1e-9, -1e-5, 0.2999999,
                                                  0.3, 0.30001]])

    def slope(v):
        v = mpmath.mpf(v)
        if v == 0:
            return 0.5j
        return complex(((v * mpmath.cos(v) - mpmath.sin(v))
                        + 1j * (v * mpmath.sin(v) + mpmath.cos(v) - 1))
                       / v**2)
    got = numeric._first_order_integral_slope(_t(x / 0.7), _t(0.7))
    want = 0.49 * np.array([slope(v) for v in x])
    assert (np.abs(got.numpy() - want) / np.abs(want)).max() <= 1e-14


def test_degenerate_propagator_gradient_matches_finite_differences(
        qft_arrays):
    """The gradient of a general function of the propagators, Re tr(A Q)
    for random A, through numeric.diagonalize on two degenerate flagship
    segments: finite and within 1e-7 of central finite differences,
    which needs the first-order terms inside the degenerate eigenspaces
    that _Eigh's mask drops (numeric._DegeneratePropagator)."""
    c_opers, cc, dt = (qft_arrays[k] for k in ('c_opers', 'c_coeffs', 'dt'))
    rng = np.random.default_rng(3)
    a = _t(rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16)))

    def loss(c):
        h = torch.einsum('jmn,jg->gmn', _t(c_opers), c.to(torch.complex128))
        _, _, props = numeric.diagonalize(h, _t(dt[1:3]))
        return (a @ props[-1]).diagonal().sum().real

    c0 = cc[:, 1:3]
    c_t = _t(c0).requires_grad_(True)
    got, = torch.autograd.grad(loss(c_t), c_t)
    assert torch.isfinite(got).all()
    fd = np.zeros_like(c0)
    for idx in np.ndindex(*c0.shape):
        e = np.zeros_like(c0)
        e[idx] = 1e-6
        fd[idx] = (loss(_t(c0 + e)) - loss(_t(c0 - e))).item() / 2e-6
    assert _rel(got.numpy(), fd) <= 1e-7


# -----------------------------------------------------------------------------
# the factored Ozaki product
# -----------------------------------------------------------------------------
def _ozaki_inputs(seed, lead=(2,), M=8, K=512, J=3, C=5):
    rng = np.random.default_rng(seed)

    def real(*shape, dtype=torch.float64):
        return _t(rng.standard_normal(lead + shape)).to(dtype) \
            .requires_grad_(True)
    return (real(M, K, dtype=torch.float32), real(M, K, dtype=torch.float32),
            real(K, J), real(K, J), real(K, C), real(K, C))


def test_ozaki_function_forward_is_the_unchanged_forward():
    """ozaki_matmul_c_outer as an autograd Function returns exactly the
    forward pass it wraps, and the result carries a gradient."""
    args = _ozaki_inputs(1)
    got = ozaki.ozaki_matmul_c_outer(*args, 24)
    with torch.no_grad():
        want = ozaki._ozaki_outer_forward(*args, 24)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(g.grad_fn is not None for g in got)


def test_ozaki_backward_matches_explicit_product(monkeypatch):
    """The backward against autograd of the explicit complex128 P @ D on
    the same inputs: dB and dC within 1e-12, dP within float32 rounding
    (it is returned in P's dtype, as the JAX package's custom VJP does);
    the backward calls no digit kernel."""
    args = _ozaki_inputs(2)
    rng = np.random.default_rng(3)
    w_re, w_im = (_t(rng.standard_normal((2, 8, 15))) for _ in range(2))
    calls = []
    digits = dword.dword_digits
    monkeypatch.setattr(dword, 'dword_digits',
                        lambda *a: calls.append(1) or digits(*a))
    out_re, out_im = ozaki.ozaki_matmul_c_outer(*args, 24)
    forward_calls = len(calls)
    got = torch.autograd.grad((w_re * out_re + w_im * out_im).sum(), args)
    assert forward_calls == 1 and len(calls) == 1

    p_re, p_im, b_re, b_im, c_re, c_im = args
    p = torch.complex(p_re.double(), p_im.double())
    b, c = torch.complex(b_re, b_im), torch.complex(c_re, c_im)
    d = (b[..., :, None] * c[..., None, :]).reshape(2, 512, 15)
    out = p @ d
    want = torch.autograd.grad(
        (w_re * out.real + w_im * out.imag).sum(), args)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == args[k].dtype
        assert _rel(g.detach().numpy(), w.numpy()) <= (
            1e-6 if k < 2 else 1e-12)


# -----------------------------------------------------------------------------
# batched_infidelity
# -----------------------------------------------------------------------------
def test_batched_infidelity_grad_matches_jax_grad():
    """Autograd of the port's batched_infidelity (native route, batch 3,
    random d = 2 pulses) against jax.grad of the JAX package's: within
    1e-12."""
    rng = np.random.default_rng(5)
    c_opers, _, _, n_opers, _, _, dt = rand_pulse_arrays(2, 4, 2, 2,
                                                         local_rng=rng)
    cc = rng.standard_normal((3, 2, 4))
    nc = rng.random((3, 2, 4))
    dts = np.broadcast_to(dt, (3, 4)).copy()
    omega = np.geomspace(0.1, 30, 40)
    spectrum = 1e-3 / omega
    basis = ff.Basis.ggm(2)
    jp = jfunctional.PulseArrays(cplx.asc(c_opers), jnp.asarray(cc),
                                 cplx.asc(n_opers), jnp.asarray(nc),
                                 jnp.asarray(dts), basis.dev)
    want = np.asarray(jax.grad(lambda c: jfunctional.batched_infidelity(
        jp._replace(c_coeffs=c), spectrum, omega).sum())(jnp.asarray(cc)))
    p = functional.PulseArrays(_t(c_opers), _t(cc), _t(n_opers), _t(nc),
                               _t(dts), fft.Basis.ggm(2).tensor('cpu'))
    got = _grad(p, _t(spectrum), _t(omega))
    assert _rel(got.numpy(), want) <= 1e-12


def _deep_pulse(batch):
    """Random d = 4 pulses of 80 segments: K = 80 d^2 = 1280, the deep
    factored regime (tests/test_gradient.py::
    test_jax_grad_through_deep_factored_contraction)."""
    rng = np.random.default_rng(6)
    c_opers, _, cc, n_opers, _, nc, dt = rand_pulse_arrays(
        4, 80, n_cops=2, n_nops=1, local_rng=rng)
    scales = 1 + 0.05 * rng.standard_normal((batch, 1, 1))
    scales[0] = 1
    p = functional.PulseArrays(
        _t(c_opers), _t(cc[None] * scales), _t(n_opers),
        _t(np.broadcast_to(nc, (batch,) + nc.shape).copy()),
        _t(np.broadcast_to(dt, (batch, 80)).copy()),
        fft.Basis.ggm(4).tensor('cpu'))
    return (c_opers, cc, n_opers, nc, dt), p


def test_deep_ozaki_gradient_matches_native_and_jax(monkeypatch):
    """jax.grad's deep case: the gradient of sum |B|^2 through the
    port's Ozaki route (escalation off) within 1e-5 of its native route
    and of jax.grad through the JAX package's Ozaki route
    (FF_TPU_CONTRACT=ozaki FF_TPU_TRANSFORM_MXU=0), at 11 frequencies."""
    (c_opers, cc, n_opers, nc, dt), p = _deep_pulse(1)
    omega = np.linspace(0.1, 10, 11)
    one = p._replace(c_coeffs=p.c_coeffs[0], n_coeffs=p.n_coeffs[0],
                     dt=p.dt[0])

    def port(contract):
        c = one.c_coeffs.clone().requires_grad_(True)
        ctrl = functional.control_matrix(one._replace(c_coeffs=c), _t(omega),
                                         contract, escalation_tol=0)
        grad, = torch.autograd.grad((ctrl.abs()**2).sum(), c)
        return grad.numpy()
    ozaki_grad, native_grad = port('ozaki'), port('native')
    assert _rel(ozaki_grad, native_grad) <= 1e-5

    monkeypatch.setenv('FF_TPU_CONTRACT', 'ozaki')
    monkeypatch.setenv('FF_TPU_TRANSFORM_MXU', '0')

    def jax_loss(c):
        ham = ff.util.ceinsum('jmn,jg->gmn', cplx.asc(c_opers), c)
        eigvals, eigvecs, props = jnumeric.diagonalize(ham, jnp.asarray(dt))
        ctrl = jnumeric.calculate_control_matrix_from_scratch(
            eigvals, eigvecs, props, jnp.asarray(omega), ff.Basis.ggm(4),
            cplx.asc(n_opers), nc, dt)
        return (ctrl.re**2 + ctrl.im**2).sum()
    jax_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(cc)))
    assert _rel(ozaki_grad, jax_grad) <= 1e-5


def test_chunked_and_escalated_gradients():
    """Autograd through batched_infidelity on the Ozaki route in chunks
    of one pulse is finite and within 1e-5 of the native route; with a
    tiny escalation threshold the batch reruns natively and the gradient
    is the native one within 1e-12; the escalation statistic carries no
    gradient."""
    _, p = _deep_pulse(2)
    omega = _t(np.linspace(0.1, 10, 11))
    spectrum = 1e-3 / omega
    native = _grad(p, spectrum, omega, contract='native')
    chunked = _grad(p, spectrum, omega, chunk_size=1, contract='ozaki',
                    escalation_tol=0)
    forced = _grad(p, spectrum, omega, chunk_size=1, contract='ozaki',
                   escalation_tol=1e-30)
    assert torch.isfinite(chunked).all()
    assert _rel(chunked.numpy(), native.numpy()) <= 1e-5
    assert _rel(forced.numpy(), native.numpy()) <= 1e-12
    c = p.c_coeffs.clone().requires_grad_(True)
    _, ratios = functional._batched_stat(p._replace(c_coeffs=c), spectrum,
                                         omega, 1, 'stat', 'ozaki')
    assert ratios.grad_fn is None and (ratios > 0).all()


# -----------------------------------------------------------------------------
# the flagship
# -----------------------------------------------------------------------------
def test_cut_flagship_gradient_matches_analytic_derivative(qft_arrays):
    """The flagship's first three segments (16, 112 and 112 exactly
    degenerate ordered eigenvalue pairs) at 16 frequencies: the port's
    autograd (native route) is within 1e-10 of the JAX package's analytic
    infidelity_derivative and of the port's, and within 1e-6 of central
    finite differences.  jax.grad of the JAX package's batched_infidelity
    is off by more than 1e-2: its eigh derivative drops the first-order
    terms inside the degenerate eigenspaces."""
    g = 3
    a = {k: qft_arrays[k][..., :g] if k in ('c_coeffs', 'n_coeffs', 'dt')
         else qft_arrays[k] for k in qft_arrays}
    ids_c = [f'A_{i:02d}' for i in range(18)]
    ids_n = [f'B_{i:02d}' for i in range(18)]
    omega = np.geomspace(1e-2, 1e2, 16)
    spectrum = 1e-4 / omega
    p = fft.PulseSequence.from_arrays(
        a['c_opers'], ids_c, a['c_coeffs'], a['n_opers'], ids_n,
        a['n_coeffs'], a['dt'], device='cpu')
    pa = functional.make_pulse_arrays(p)
    batched = pa._replace(c_coeffs=pa.c_coeffs[None],
                          n_coeffs=pa.n_coeffs[None], dt=pa.dt[None])
    got = _grad(batched, _t(spectrum), _t(omega))[0].numpy()

    jp = ff.PulseSequence.from_arrays(
        a['c_opers'], ids_c, a['c_coeffs'], a['n_opers'], ids_n,
        a['n_coeffs'], a['dt'], basis=ff.Basis.ggm(16))
    want = np.asarray(ff.infidelity_derivative(jp, spectrum, omega)).sum(0).T
    assert _rel(got, want) <= 1e-10
    port = fft.infidelity_derivative(p, spectrum, omega).sum(0).T.numpy()
    assert _rel(port, want) <= 1e-10

    def infid(c):
        return functional.batched_infidelity(
            batched._replace(c_coeffs=_t(c)[None]), _t(spectrum),
            _t(omega)).sum().item()
    for idx in [(0, 0), (3, 1), (10, 2)]:
        e = np.zeros_like(a['c_coeffs'])
        e[idx] = 1e-6
        fd = (infid(a['c_coeffs'] + e) - infid(a['c_coeffs'] - e)) / 2e-6
        assert abs(got[idx] - fd) <= 1e-6 * np.abs(got).max()

    jbatch = jfunctional.PulseArrays(
        cplx.asc(a['c_opers']), jnp.asarray(a['c_coeffs'][None]),
        cplx.asc(a['n_opers']), jnp.asarray(a['n_coeffs'][None]),
        jnp.asarray(a['dt'][None]), ff.Basis.ggm(16).dev)
    jax_grad = np.asarray(jax.grad(lambda c: jfunctional.batched_infidelity(
        jbatch._replace(c_coeffs=c), spectrum, omega).sum())(
            jbatch.c_coeffs))[0]
    assert _rel(jax_grad, want) > 1e-2


def test_flagship_gradient_is_finite_and_matches_finite_differences(
        qft_arrays):
    """The whole flagship (13 segments) at 64 frequencies, batch 1,
    native route: the gradient has no NaN and matches central finite
    differences within 1e-6 at three coefficients, one of them moving
    only inside degenerate eigenspaces at first order."""
    p = qft.qft_pulse_arrays(4, device='cpu')
    p = p._replace(c_coeffs=p.c_coeffs[None], n_coeffs=p.n_coeffs[None],
                   dt=p.dt[None])
    omega = _t(np.geomspace(1e-2, 1e2, 64))
    spectrum = 1e-4 / omega
    grad = _grad(p, spectrum, omega)[0]
    assert torch.isfinite(grad).all()
    c0 = qft_arrays['c_coeffs']

    def infid(c):
        return functional.batched_infidelity(
            p._replace(c_coeffs=_t(c)[None]), spectrum, omega).sum().item()
    for idx in [(0, 0), (3, 5), (10, 7)]:
        e = np.zeros_like(c0)
        e[idx] = 1e-6
        fd = (infid(c0 + e) - infid(c0 - e)) / 2e-6
        assert abs(grad[idx].item() - fd) <= 1e-6 * grad.abs().max().item()
