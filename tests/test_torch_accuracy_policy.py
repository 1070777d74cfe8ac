"""The port's counterpart of tests/test_accuracy_policy.py: the deep
factored Ozaki route (the contraction CUDA takes by default,
``config.contraction_mode``) held to a randomized parity ensemble and to
its automatic escalation on a real cancellation pathology.

On the CPU the route runs the plain version of ``dword_digits``; the
fixture ``cuda_default_route`` makes the default route of CPU tensors
the one CUDA tensors take, as the JAX package's tests set
``FF_TPU_CONTRACT=ozaki``, so that the object path and the functional
entry points run it without being told.  Each contraction's escalation
argument on that route ('stat' for the fast pass with its statistic,
'force' for the full-precision rerun) is recorded by ``contractions``.

1. The ensemble: seeded random pulses at the shapes (d, G) = (4, 128),
   (8, 32), (16, 8), all of depth K = G d^2 = 2048 inside the deep
   window 1024 < K <= 16384, 5 seeds each (4-row batches for the batched
   entry point), under white, 1/f and Lorentzian spectra at 200
   frequencies.  The criterion is JAX's: relative parity <= 2.5e-7
   (half of 1e-10 absolute at the flagship's per-operator infidelity
   scale, since the infidelity is linear in the spectrum) against the
   port's native route and against the JAX package's native infidelity
   on the same numpy inputs, with no escalation.  JAX's batched ETM leg
   has no counterpart: the port's functional ETM contracts each segment
   in complex128 and has no Ozaki route.
2. The escalation: the CPMG-300 train (d = 2, 601 segments, K = 2404)
   refocuses its dephasing filter function by ~11 orders of magnitude at
   small omega; under S = 1e-3/omega^2 the fast pass's operand
   quantization shows in the integral.  Its statistic must exceed
   ``config.ESCALATION_TOL``, the unescalated result must be visibly off
   native, and the escalated one native within 1e-12 relative.
"""
import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import config, functional, numeric
from filter_functions_tpu_torch.models import dd
from testutil import generate_dd_hamiltonian, make_pulse, rand_pulse_arrays
from torch_testutil import fft_cpu

SHAPES = [(4, 128), (8, 32), (16, 8)]
N_SEEDS = 5
N_OMEGA = 200
#: JAX's relative-parity ceiling (tests/test_accuracy_policy.py).
REL_TOL = 2.5e-7
#: The escalated result against the native route, relative.
ESCALATED_TOL = 1e-12


@pytest.fixture
def cuda_default_route(monkeypatch):
    """contract=None resolves to 'ozaki' for CPU tensors too."""
    resolve = config.contraction_mode
    monkeypatch.setattr(config, 'contraction_mode',
                        lambda device, contract=None:
                        resolve('cuda' if contract is None else device,
                                contract))


@pytest.fixture
def contractions(monkeypatch):
    """The (escalation, largest statistic) of every call of
    numeric._ctrlmat_contract on the 'ozaki' route, in order."""
    calls = []
    contract = numeric._ctrlmat_contract

    def recorded(n_t, integral, b_t, ph, escalation='stat',
                 mode='native'):
        out, ratio = contract(n_t, integral, b_t, ph, escalation, mode)
        if mode == 'ozaki':
            calls.append((escalation, ratio.max().item()))
        return out, ratio

    monkeypatch.setattr(numeric, '_ctrlmat_contract', recorded)
    return calls


def _spectra(omega):
    return {'white': np.full_like(omega, 1e-4),
            'one_over_f': 1e-4 / omega,
            'lorentzian': 1e-3 / (1 + omega**2)}


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_deep_policy_parity_ensemble(cuda_default_route, contractions):
    """``fft.infidelity`` of 15 seeded random pulses through the object
    path on the default CUDA route (JAX test_accuracy_policy.py:72), each
    spectrum's summed infidelity within 2.5e-7 relative of the port's
    native route and of the JAX package's native infidelity; one fast
    pass per pulse and no escalation.  Measured worst case 5.52e-8 at
    (d = 8, seed 2, 1/f)."""
    omega = np.geomspace(1e-2, 1e2, N_OMEGA)
    spectra = _spectra(omega)
    worst = (0.0, None)
    for d, G in SHAPES:
        for seed in range(N_SEEDS):
            arrays = rand_pulse_arrays(d, G, n_cops=2, n_nops=2,
                                       local_rng=np.random.default_rng(
                                           1000 * d + seed))
            deep, native = (make_pulse(arrays, cls=fft_cpu)
                            for _ in range(2))
            jpulse = make_pulse(arrays)
            native.cache_control_matrix(
                omega, numeric.calculate_control_matrix_from_scratch(
                    native.eigvals, native.eigvecs, native.propagators,
                    omega, native.basis, native.n_opers_dev,
                    native.n_coeffs, native.dt, t=native.t,
                    contract='native'))
            for name, s in spectra.items():
                got = fft.infidelity(deep, s, omega).sum().item()
                wants = (fft.infidelity(native, s, omega).sum().item(),
                         float(np.asarray(ff.infidelity(jpulse, s,
                                                        omega)).sum()))
                for want in wants:
                    rel = abs(got - want) / abs(want)
                    if rel > worst[0]:
                        worst = (rel, (d, seed, name))
                    assert rel <= REL_TOL, (d, seed, name, rel)
    assert [e for e, _ in contractions] == ['stat'] * len(SHAPES) * N_SEEDS
    assert max(r for _, r in contractions) < config.ESCALATION_TOL
    print(f'worst relative parity {worst[0]:.3e} at {worst[1]} (ceiling '
          f'{REL_TOL})')


def _deep_batch(d=4, G=128, batch=2, n_omega=32):
    """JAX test_accuracy_policy.py:130's deep batch (K = 2048) as the
    port's PulseArrays: rows scaled by 1 + 0.01 i."""
    arrays = rand_pulse_arrays(d, G, n_cops=2, n_nops=2,
                               local_rng=np.random.default_rng(0))
    p = functional.make_pulse_arrays(make_pulse(arrays, cls=fft_cpu))
    scales = torch.tensor([1 + 0.01 * i for i in range(batch)])
    pb = p._replace(c_coeffs=scales[:, None, None] * p.c_coeffs,
                    n_coeffs=p.n_coeffs.expand(batch, -1, -1),
                    dt=p.dt.expand(batch, -1))
    omega = torch.tensor(np.geomspace(1e-1, 1e1, n_omega))
    return pb, 1e-3 / omega, omega


@pytest.mark.parametrize('chunk_size', [None, 1])
def test_batched_fast_path_carries_no_escalation(chunk_size,
                                                 cuda_default_route,
                                                 contractions):
    """The eager counterpart of JAX's jaxpr pin (test_accuracy_policy.py:
    146): a healthy ``functional.batched_infidelity`` at the deep shape
    makes exactly one 'stat' contraction per chunk and no 'force'
    contraction, and its result is the fast pass's with escalation
    disabled, bit for bit."""
    pb, spectrum, omega = _deep_batch()
    got = functional.batched_infidelity(pb, spectrum, omega, chunk_size)
    n_chunks = 2 if chunk_size == 1 else 1
    assert [e for e, _ in contractions] == ['stat'] * n_chunks
    assert max(r for _, r in contractions) < config.ESCALATION_TOL
    fast = functional.batched_infidelity(pb, spectrum, omega, chunk_size,
                                         escalation_tol=0)
    assert torch.equal(got, fast)
    assert [e for e, _ in contractions] == ['stat'] * 2 * n_chunks


def test_batched_deep_policy_parity_ensemble(cuda_default_route,
                                             contractions):
    """``functional.batched_infidelity`` of a 4-row batch per deep shape
    (seeded coefficients, noise coefficients and durations over shared
    operators; JAX test_accuracy_policy.py:200) on the default CUDA
    route: every row's summed infidelity within 2.5e-7 relative of the
    port's native route and of the JAX package's batched native
    infidelity, with no escalation."""
    from filter_functions_tpu import functional as jfunctional
    omega = np.geomspace(1e-2, 1e2, N_OMEGA)
    spectra = _spectra(omega)
    n_batch = 4
    for d, G in SHAPES:
        rng = np.random.default_rng(2000 * d)
        arrays = rand_pulse_arrays(d, G, n_cops=2, n_nops=2, local_rng=rng)
        p = functional.make_pulse_arrays(make_pulse(arrays, cls=fft_cpu))
        cc = np.stack([p.c_coeffs.numpy()] * n_batch)
        cc *= rng.standard_normal((n_batch, 1, 1)) * 0.3 + 1.0
        nc = np.stack([rng.random(p.n_coeffs.shape) for _ in range(n_batch)])
        dts = np.stack([1 - rng.random(p.dt.shape) for _ in range(n_batch)])
        pb = p._replace(c_coeffs=torch.tensor(cc), n_coeffs=torch.tensor(nc),
                        dt=torch.tensor(dts))
        jp = jfunctional.make_pulse_arrays(make_pulse(arrays))
        jb = jfunctional.PulseArrays(jp.c_opers, cc, jp.n_opers, nc, dts,
                                     jp.basis)
        w = torch.tensor(omega)
        for name, s in spectra.items():
            s = torch.tensor(s)
            got = functional.batched_infidelity(pb, s, w).sum(-1).numpy()
            native = functional.batched_infidelity(
                pb, s, w, contract='native').sum(-1).numpy()
            jax_native = np.asarray(jfunctional.batched_infidelity(
                jb, s.numpy(), omega)).sum(-1)
            for want in (native, jax_native):
                rel = (np.abs(got - want) / np.abs(want)).max()
                assert rel <= REL_TOL, (d, G, name, rel)
    assert [e for e, _ in contractions] == ['stat'] * len(SHAPES) * 3
    assert max(r for _, r in contractions) < config.ESCALATION_TOL


def _cpmg_300():
    """The CPMG-300 train of JAX test_accuracy_policy.py:297 through the
    port's own constructor (``models.dd.dd_pulse``; pulses of width 1e-2 in
    tau = 10, Z/2 noise), checked equal to testutil's generator."""
    pulse = dd.dd_pulse(300, tau=10, tau_pi=1e-2, dd_type='cpmg',
                        device='cpu')
    (((_, coeffs),), dt) = generate_dd_hamiltonian(300, tau=10, tau_pi=1e-2,
                                                   dd_type='cpmg')
    np.testing.assert_allclose(pulse.c_coeffs[0], coeffs, rtol=0, atol=0)
    np.testing.assert_allclose(pulse.dt, dt, rtol=0, atol=1e-15)
    assert len(dt) * pulse.d**2 == 2404
    return pulse


def test_batched_escalation_on_cancellation_pathology(cuda_default_route,
                                                      contractions):
    """CPMG-300 through ``functional.batched_infidelity`` (a batch of the
    train and a 1e-7 perturbation of it, S = 1e-3/omega^2, 100
    frequencies in geomspace(1e-4, 1e2); JAX test_accuracy_policy.py:283):
    the fast pass's statistic exceeds ``config.ESCALATION_TOL``; with
    escalation disabled the result is more than 1e-7 (relative to the
    largest infidelity) off the native route (4.333e-7 measured); with
    the default escalation the batch reruns at full precision, within
    1e-12 of native."""
    p = functional.make_pulse_arrays(_cpmg_300())
    pb = p._replace(c_coeffs=torch.stack([p.c_coeffs,
                                          p.c_coeffs * 1.0000001]),
                    n_coeffs=p.n_coeffs.expand(2, -1, -1),
                    dt=p.dt.expand(2, -1))
    omega = torch.tensor(np.geomspace(1e-4, 1e2, 100))
    spectrum = 1e-3 / omega**2
    want = functional.batched_infidelity(pb, spectrum, omega,
                                         contract='native').numpy()
    fast = functional.batched_infidelity(pb, spectrum, omega,
                                         escalation_tol=0).numpy()
    assert [e for e, _ in contractions] == ['stat']
    escalated = functional.batched_infidelity(pb, spectrum, omega).numpy()
    assert [e for e, _ in contractions] == ['stat', 'stat', 'force']
    assert contractions[1][1] > config.ESCALATION_TOL
    assert _rel(fast, want) > 1e-7, _rel(fast, want)
    assert _rel(escalated, want) <= ESCALATED_TOL, _rel(escalated, want)


def test_escalation_on_cancellation_pathology(cuda_default_route,
                                              contractions, monkeypatch):
    """CPMG-300 through the object path (``get_filter_function``, one
    segment chunk; JAX test_accuracy_policy.py:336): the statistic
    exceeds ``config.ESCALATION_TOL`` and the chunk reruns at full
    precision, so that the filter function is within 1e-12 elementwise
    relative of the native route's (JAX: 1e-4); with escalation disabled
    (``config.ESCALATION_TOL = 0``) it is more than 3e-4 off at its worst
    frequency (5.154e-4 measured)."""
    omega = np.geomspace(1e-4, 1e2, 100)

    def filter_function():
        return _cpmg_300().get_filter_function(omega).real.numpy()

    default = filter_function()
    assert [e for e, _ in contractions] == ['stat', 'force']
    assert contractions[0][1] > config.ESCALATION_TOL
    monkeypatch.setattr(config, 'ESCALATION_TOL', 0)
    fast = filter_function()
    pulse = _cpmg_300()
    native = numeric.calculate_filter_function(
        numeric.calculate_control_matrix_from_scratch(
            pulse.eigvals, pulse.eigvecs, pulse.propagators, omega,
            pulse.basis, pulse.n_opers_dev, pulse.n_coeffs, pulse.dt,
            t=pulse.t, contract='native'), 'fidelity').real.numpy()
    floor = np.abs(native).max() * 1e-30

    def rel(f):
        return (np.abs(f - native)
                / np.maximum(np.abs(native), floor)).max()

    assert rel(fast) > 3e-4, rel(fast)
    assert rel(default) <= ESCALATED_TOL, rel(default)
