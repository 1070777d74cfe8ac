"""The PyTorch port's superoperator utilities (filter_functions_tpu_torch.
superoperator) against the JAX package's, on the same random unitaries
and superoperators from a seeded numpy generator."""
import numpy as np
import pytest
import torch

from filter_functions_tpu import superoperator as jsuper
from filter_functions_tpu.basis import Basis as JBasis
from filter_functions_tpu.cplx import asc
from filter_functions_tpu_torch import basis, superoperator
from testutil import rand_unit


def _jax_np(x):
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _bases(name, d):
    if name == 'ggm':
        return JBasis.ggm(d), basis.Basis.ggm(d)
    if name == 'pauli':
        return JBasis.pauli(int(np.log2(d))), basis.Basis.pauli(
            int(np.log2(d)))
    rng = np.random.default_rng(d)
    arr = rng.standard_normal((d * d, d, d)) + 1j * rng.standard_normal(
        (d * d, d, d))
    return JBasis(arr), basis.Basis(arr)


@pytest.mark.parametrize('name, d', [('ggm', 2), ('ggm', 3), ('pauli', 4),
                                     ('custom', 2)])
def test_liouville_representation_matches_jax(name, d):
    """Liouville representation of a batch of random unitaries: within
    1e-13 absolute of JAX (measured <= 3.4e-16 for the hermitian bases,
    9.7e-16 for the unnormalized custom one); real for a hermitian
    basis, complex otherwise."""
    jb, tb = _bases(name, d)
    u = rand_unit(d, 3, np.random.default_rng(20 + d))
    want = _jax_np(jsuper.liouville_representation(asc(u), jb))
    got = superoperator.liouville_representation(torch.tensor(u), tb)
    assert got.is_complex() == (not tb.isherm)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    single = superoperator.liouville_representation(torch.tensor(u[0]), tb)
    np.testing.assert_allclose(single.numpy(), want[0], rtol=0, atol=1e-13)


@pytest.mark.parametrize('d', [2, 3])
def test_liouville_to_choi_matches_jax(d):
    """choi of random superoperators, real and complex, single and
    batched: within 1e-13 of JAX (measured <= 8.9e-16)."""
    jb, tb = _bases('ggm', d)
    rng = np.random.default_rng(30 + d)
    real = rng.standard_normal((2, d * d, d * d))
    for s in (real, real + 1j * rng.standard_normal(real.shape), real[0]):
        want = _jax_np(jsuper.liouville_to_choi(
            asc(s) if np.iscomplexobj(s) else s, jb))
        got = superoperator.liouville_to_choi(torch.tensor(s), tb)
        assert got.shape == (*s.shape[:-2], d * d, d * d)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


@pytest.mark.parametrize('d', [2, 3])
def test_cp_and_ccp_match_jax(d):
    """The CP and cCP verdicts equal JAX's: true for unitary channels
    (and cCP for their generators' neighbours), false for a random
    superoperator; batched verdicts come back per element; the
    eigenvalues returned with return_eig agree within 1e-12 (measured
    3.6e-15); a large atol accepts everything."""
    jb, tb = _bases('ggm', d)
    rng = np.random.default_rng(40 + d)
    u = rand_unit(d, 2, rng)
    unitary = _jax_np(jsuper.liouville_representation(asc(u), jb))
    noise = rng.standard_normal((d * d, d * d))
    for s in (unitary, unitary[0], noise, unitary[0] + 1e-3 * noise):
        for fn in ('liouville_is_CP', 'liouville_is_cCP'):
            want, (w_eig, _) = getattr(jsuper, fn)(s, jb, return_eig=True)
            got, (g_eig, _) = getattr(superoperator, fn)(
                torch.tensor(s), tb, return_eig=True)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
            np.testing.assert_allclose(g_eig.numpy(), np.asarray(w_eig),
                                       rtol=0, atol=1e-12)
            assert torch.as_tensor(getattr(superoperator, fn)(
                torch.tensor(s), tb, atol=1e3)).all()
