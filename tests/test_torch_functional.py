"""The PyTorch port's flagship path (filter_functions_tpu_torch.functional)
against the JAX package: the batched infidelity of the 4-qubit QFT
pulse, as bench.py's flagship configuration builds it.

Both packages get the same numpy inputs.  The JAX oracle of the native
route is the CPU default; its Ozaki route runs with
``FF_TPU_CONTRACT=ozaki`` and ``FF_TPU_TRANSFORM_MXU=0`` (exact einsum
conjugations, as the port computes them), set only around the oracle
calls.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu import numeric as jnumeric
from filter_functions_tpu.cplx import ceinsum
from filter_functions_tpu_torch import convert, functional, numeric
from filter_functions_tpu_torch.models import qft
from filter_functions_tpu_torch.ops import dword

REPO = Path(__file__).resolve().parents[1]
BATCH = 2
#: Frequencies of the Ozaki-route tests that need the JAX Ozaki oracle:
#: K, J, C and the digit layout are the flagship's, only n_omega shrinks.
N_OMEGA_SMALL = 64


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope='module')
def flagship():
    """Rows 0 and 1 of bench.py's batch: row 0 the QFT pulse, row 1 its
    control coefficients scaled by 1 + 0.05 N(0, 1) from
    default_rng(0)."""
    p = jax.tree.map(np.asarray, __graft_entry__._qft_pulse_arrays(4))
    rng = np.random.default_rng(0)
    scales = 1 + 0.05 * rng.standard_normal((32, 1, 1))
    scales[0] = 1.0
    cc = p.c_coeffs[None] * scales[:BATCH]
    nc = np.broadcast_to(p.n_coeffs, (BATCH,) + p.n_coeffs.shape).copy()
    dt = np.broadcast_to(p.dt, (BATCH,) + p.dt.shape).copy()
    jax_batch = jfunctional.PulseArrays(p.c_opers, cc, p.n_opers, nc, dt,
                                        p.basis)
    port = convert.pulse_arrays_from_numpy(jax_batch, device='cpu')
    return p, jax_batch, port


def _omega(n):
    omega = np.geomspace(1e-2, 1e2, n)
    return omega, 1e-4 / omega


@pytest.fixture(scope='module')
def jax_native(flagship):
    """JAX's batched infidelity (native route), 1000 frequencies."""
    _, jax_batch, _ = flagship
    omega, spectrum = _omega(1000)
    return np.asarray(jfunctional.batched_infidelity(jax_batch, spectrum,
                                                     omega))


def test_native_matches_jax_native(flagship, jax_native):
    """(e) The native complex128 route against JAX's native route at the
    flagship's 1000 frequencies: within 1e-13 absolute (measured 2.7e-19
    on infidelities of 3e-4: the same complex128 arithmetic summed in
    another order)."""
    _, _, port = flagship
    omega, spectrum = _omega(1000)
    got = functional.batched_infidelity(port, _t(spectrum), _t(omega))
    assert got.shape == (BATCH, 18) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), jax_native, rtol=0, atol=1e-13)


def test_ozaki_route_matches_jax_native(flagship, jax_native):
    """(f) The Ozaki route, with the port's own eigendecomposition,
    against JAX's native route on row 0 at 1000 frequencies: the
    BASELINE.json contract, 1e-10 absolute (measured 8.83e-11 for both
    rows; JAX's own Ozaki route reads 8.8e-11 there)."""
    _, _, port = flagship
    omega, spectrum = _omega(1000)
    got = functional.batched_infidelity(port, _t(spectrum), _t(omega),
                                        contract='ozaki').numpy()
    assert np.isfinite(got).all()
    assert np.abs(got[0] - jax_native[0]).max() <= 1e-10


@pytest.fixture(scope='module')
def fed_jax_eigh(flagship):
    """The Ozaki route of both packages at 64 frequencies, the port fed
    JAX's eigendecomposition: ((JAX infidelities, JAX ratios), (port
    infidelities, port ratios)) per row."""
    p, jax_batch, port = flagship
    omega, spectrum = _omega(N_OMEGA_SMALL)
    d = p.c_opers.re.shape[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('FF_TPU_CONTRACT', 'ozaki')
        mp.setenv('FF_TPU_TRANSFORM_MXU', '0')
        want, eigh = [], []
        for b in range(BATCH):
            terms = jfunctional._infid_prep(
                jax_batch, jnp.asarray(jax_batch.c_coeffs[b]),
                jnp.asarray(jax_batch.n_coeffs[b]),
                jnp.asarray(jax_batch.dt[b]), jnp.asarray(omega))
            infid, ratio = jfunctional._infid_contract(
                terms, jnp.asarray(spectrum), jnp.asarray(omega), d, 'stat')
            want.append((np.asarray(infid), float(ratio)))
            ham = ceinsum('jmn,jg->gmn', p.c_opers,
                          jnp.asarray(jax_batch.c_coeffs[b]))
            eigh.append(jax.tree.map(np.asarray, jnumeric._diagonalize_jit(
                ham, jnp.asarray(jax_batch.dt[b]))))
    cplx = lambda c: c.re + 1j * c.im
    w = _t(np.stack([e[0] for e in eigh]))
    v = _t(np.stack([cplx(e[1]) for e in eigh]))
    q = _t(np.stack([cplx(e[2]) for e in eigh]))
    dt = port.dt
    t = torch.cat([torch.zeros_like(dt[:, :1]), torch.cumsum(dt, -1)], -1)
    terms = numeric._ctrlmat_step_terms(
        w, v, q[:, :-1], _t(omega), port.basis, port.n_opers,
        port.n_coeffs, dt, t[:, :-1])
    got = functional._infid_contract(terms, _t(spectrum), _t(omega), d,
                                     'stat', 'ozaki')
    return want, got


def test_ozaki_route_fed_jax_eigh_matches_jax_ozaki(fed_jax_eigh):
    """(g) With the eigendecomposition pinned, the port's Ozaki route
    against JAX's: within 1e-12 absolute on the infidelities (rounding
    of the step terms can flip single 23-bit quantizations), 1e-3
    relative on the escalation statistic (float32 sums in another
    order), which stays below the escalation threshold 0.1."""
    want, (infid, ratio) = fed_jax_eigh
    for b, (w_infid, w_ratio) in enumerate(want):
        assert np.abs(infid[b].numpy() - w_infid).max() <= 1e-12
        assert abs(ratio[b].item() - w_ratio) <= 1e-3 * w_ratio
        assert 0 < ratio[b].item() < functional.config.ESCALATION_TOL


@pytest.mark.parametrize('contract', ['native', 'ozaki'])
def test_chunking_is_bit_identical(contract, flagship):
    """(h) chunk_size=1 gives the same bits as one chunk."""
    _, _, port = flagship
    omega, spectrum = map(_t, _omega(N_OMEGA_SMALL))
    whole = functional.batched_infidelity(port, spectrum, omega,
                                          contract=contract)
    chunked = functional.batched_infidelity(port, spectrum, omega,
                                            chunk_size=1, contract=contract)
    assert torch.equal(whole, chunked)


def test_escalation_reruns_on_native_route(flagship):
    """(i) A tiny escalation threshold forces the full-precision re-run,
    which is the native route, bit for bit; a zero threshold never
    escalates."""
    _, _, port = flagship
    omega, spectrum = map(_t, _omega(N_OMEGA_SMALL))
    native = functional.batched_infidelity(port, spectrum, omega,
                                           contract='native')
    forced = functional.batched_infidelity(port, spectrum, omega,
                                           contract='ozaki',
                                           escalation_tol=1e-30)
    fast = functional.batched_infidelity(port, spectrum, omega,
                                         contract='ozaki', escalation_tol=0)
    assert torch.equal(forced, native)
    assert not torch.equal(fast, native)
    assert np.abs((fast - native).numpy()).max() < 1e-10


def test_bad_chunk_size_raises(flagship):
    """A chunk size below 1 is refused (one of at least the batch means
    one chunk, as in the JAX package)."""
    _, _, port = flagship
    omega, spectrum = map(_t, _omega(8))
    with pytest.raises(ValueError, match='chunk_size'):
        functional.batched_infidelity(port, spectrum, omega, chunk_size=0)


def test_single_pulse_entry_points(flagship):
    """infidelity of one pulse is row 0 of the batch, and control_matrix
    integrates to it: |B|^2 summed over the basis, times the spectrum,
    trapezoid over omega, over 2 pi d."""
    p, _, port = flagship
    omega, spectrum = map(_t, _omega(N_OMEGA_SMALL))
    one = port._replace(c_coeffs=port.c_coeffs[0], n_coeffs=port.n_coeffs[0],
                        dt=port.dt[0])
    infid = functional.infidelity(one, spectrum, omega)
    batch = functional.batched_infidelity(port, spectrum, omega)
    np.testing.assert_allclose(infid.numpy(), batch[0].numpy(), rtol=1e-14,
                               atol=0)
    ctrl = functional.control_matrix(one, omega)
    assert ctrl.shape == (18, 256, N_OMEGA_SMALL)
    assert ctrl.dtype == torch.complex128
    f = (ctrl.abs()**2).sum(1) * spectrum
    integral = ((f[:, 1:] + f[:, :-1]) * torch.diff(omega)).sum(-1) / 2
    np.testing.assert_allclose((integral / (2 * np.pi * 16)).numpy(),
                               infid.numpy(), rtol=1e-13, atol=0)


def test_pulse_arrays_from_both_layouts():
    """convert takes the npz layout (*_re / *_im fields) and a JAX
    PulseArrays with numpy leaves to the same tensors; the QFT loader,
    which builds the pulse live and reads no file, gives those tensors
    bit for bit, and any number of qubits."""
    npz = np.load(REPO / 'filter_functions_tpu' / 'models'
                  / 'qft4_arrays.npz')
    from_npz = convert.pulse_arrays_from_numpy(dict(npz), device='cpu')
    from_jax = convert.pulse_arrays_from_numpy(
        jax.tree.map(np.asarray, __graft_entry__._qft_pulse_arrays(4)),
        device='cpu')
    loaded = qft.qft_pulse_arrays(4, device='cpu')
    for a, b, c in zip(from_npz, from_jax, loaded):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert loaded.c_opers.shape == (18, 16, 16)
    assert loaded.c_opers.dtype == torch.complex128
    assert loaded.basis.shape == (256, 16, 16)
    assert loaded.dt.dtype == torch.float64 and loaded.dt.shape == (13,)
    three = qft.qft_pulse_arrays(3, device='cpu')
    assert three.c_opers.shape[1:] == (8, 8) and three.dt.shape == (10,)
    assert three.basis.shape == (64, 8, 8)


def test_port_imports_no_jax():
    """The port package imports torch and never jax."""
    code = ('import sys, filter_functions_tpu_torch; '
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "jaxlib", "filter_functions_tpu."))]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=300)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the default CUDA route launches the '
                    'dword_digits kernel, which has no CPU mode')
    return torch.device('cuda', 0)


@pytest.mark.gpu
def test_default_cuda_route_on_card(flagship, cuda_device):
    """On the card, contract=None takes the Ozaki route through the CUDA
    kernel (one launch per chunk) and lands within the 1e-10 contract of
    the CPU's native route, at 64 frequencies."""
    _, _, port = flagship
    omega, spectrum = map(_t, _omega(N_OMEGA_SMALL))
    on_card = type(port)(*(x.to(cuda_device) for x in port))
    before = dword.launches
    got = functional.batched_infidelity(on_card, spectrum.to(cuda_device),
                                        omega.to(cuda_device), chunk_size=1)
    assert dword.launches == before + BATCH
    want = functional.batched_infidelity(port, spectrum, omega)
    assert np.abs(got.cpu().numpy() - want.numpy()).max() <= 1e-10
