"""The PyTorch port's operator bases (filter_functions_tpu_torch.basis)
against the JAX package's, on the same numpy inputs.

The constructors and the host characteristics run the JAX package's
numpy arithmetic, so their arrays are compared bit for bit; the
expansions on tensors run torch's complex arithmetic and hold within
1e-14 absolute.
"""
import numpy as np
import pytest
import torch

from filter_functions_tpu import basis as jbasis
from filter_functions_tpu.cplx import asc
from filter_functions_tpu_torch import basis, convert
from testutil import rand_herm, rand_herm_traceless

_PROPS = ('isherm', 'isnorm', 'isorthogonal', 'isorthonorm', 'istraceless',
          'iscomplete')


def _jax_np(x):
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _partial_elements(d, n, rng):
    """n orthonormal traceless Hermitian d x d matrices."""
    elems = rand_herm_traceless(d, n, rng).reshape(n, -1)
    q, _ = np.linalg.qr(elems.T)
    return q.T.reshape(n, d, d)


def _custom(rng):
    """A non-hermitian, non-normalized custom basis of d = 2."""
    return rng.standard_normal((3, 2, 2)) + 1j * rng.standard_normal(
        (3, 2, 2))


@pytest.mark.parametrize('make', [
    lambda: ('ggm', 2), lambda: ('ggm', 3), lambda: ('ggm', 4),
    lambda: ('pauli', 1), lambda: ('pauli', 2),
], ids=['ggm2', 'ggm3', 'ggm4', 'pauli1', 'pauli2'])
def test_constructors_bit_identical(make):
    """Basis.ggm(d) and Basis.pauli(n): the same elements, labels, btype
    and characteristics as the JAX package's."""
    name, arg = make()
    want = getattr(jbasis.Basis, name)(arg)
    got = getattr(basis.Basis, name)(arg)
    np.testing.assert_array_equal(got.np, want.np)
    assert got.labels == want.labels and got.btype == want.btype
    for prop in _PROPS:
        assert getattr(got, prop) == getattr(want, prop), prop
    assert not got.np.flags.writeable


@pytest.mark.parametrize('case', ['traceless', 'traceful', 'custom',
                                  'single'])
def test_characteristics_match_jax(case):
    """Every is* property of assorted custom bases equals JAX's."""
    rng = np.random.default_rng(10)
    arr = {'traceless': rand_herm_traceless(3, 4, rng),
           'traceful': rand_herm(3, 2, rng),
           'custom': _custom(rng),
           'single': np.eye(2)}[case]
    want, got = jbasis.Basis(arr), basis.Basis(arr)
    np.testing.assert_array_equal(got.np, want.np)
    for prop in _PROPS:
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize('d, n, traceless', [(2, 1, None), (3, 2, None),
                                              (4, 3, True), (3, 2, False)])
def test_from_partial_bit_identical(d, n, traceless):
    """from_partial completes a partial orthonormal set to the JAX
    package's basis bit for bit, labels included."""
    elems = _partial_elements(d, n, np.random.default_rng(d + n))
    labels = [f'l{i}' for i in range(n)]
    want = jbasis.Basis.from_partial(elems, traceless=traceless,
                                     labels=labels)
    got = basis.Basis.from_partial(elems, traceless=traceless, labels=labels)
    np.testing.assert_array_equal(got.np, want.np)
    assert got.labels == want.labels and got.btype == want.btype


def test_from_partial_errors_like_jax():
    """Non-orthogonal elements, a traceless request on traceful ones and
    a wrong label count raise ValueError in both packages."""
    rng = np.random.default_rng(11)
    cases = [dict(partial_basis_array=rand_herm(2, 2, rng)),
             dict(partial_basis_array=[np.eye(3) + rand_herm(3, 1, rng)[0]],
                  traceless=True),
             dict(partial_basis_array=_partial_elements(3, 2, rng),
                  labels=['a'])]
    for kw in cases:
        with pytest.raises(ValueError):
            jbasis.Basis.from_partial(**kw)
        with pytest.raises(ValueError):
            basis.Basis.from_partial(**kw)


def test_normalize_tidyup_transpose_bit_identical():
    """normalize (copy and in place), tidyup, T and H give JAX's arrays;
    in-place changes drop the cached device copies."""
    rng = np.random.default_rng(12)
    arr = 3 * rand_herm_traceless(3, 4, rng)
    arr[0, 0, 1] += 1e-17
    want, got = jbasis.Basis(arr), basis.Basis(arr)
    np.testing.assert_array_equal(basis.normalize(got).np,
                                  jbasis.normalize(want).np)
    np.testing.assert_array_equal(got.normalize(copy=True).np,
                                  want.normalize(copy=True).np)
    stale = got.tensor('cpu')
    want.normalize()
    got.normalize()
    np.testing.assert_array_equal(got.np, want.np)
    assert got.isnorm and not torch.equal(got.tensor('cpu'), stale)
    want.tidyup()
    got.tidyup()
    np.testing.assert_array_equal(got.np, want.np)
    np.testing.assert_array_equal(got.T.np, want.T.np)
    np.testing.assert_array_equal(got.H.np, want.H.np)


def test_equality_hash_contains():
    """==, hash and `in` follow the JAX package's tolerances; the device
    copy is complex128 and cached per device."""
    b, j = basis.Basis.ggm(3), jbasis.Basis.ggm(3)
    assert b == basis.Basis.ggm(3) and b == j.np and b == torch.tensor(j.np)
    assert not b == basis.Basis.ggm(2) and b != basis.Basis.pauli(1)
    assert hash(b) == hash(basis.Basis.ggm(3))
    assert b.np[4] in b and torch.tensor(b.np[4]) in b
    assert np.eye(3) not in b
    dev = b.tensor('cpu')
    assert dev.dtype == torch.complex128 and b.tensor('cpu') is dev
    assert repr(b) == repr(j) and len(b) == 9 and b.shape == (9, 3, 3)
    np.testing.assert_array_equal(np.asarray(b), j.np)


def test_constructor_errors_like_jax():
    """Overcomplete sets, traceful elements with traceless=True, wrong
    label counts and non-sequences raise as in the JAX package."""
    rng = np.random.default_rng(13)
    cases = [(rand_herm(2, 5, rng), {}),
             (np.ones((2, 2)), dict(traceless=True)),
             (rand_herm(2, 2, rng), dict(labels=['a'])),
             (1.0, {})]
    for arr, kw in cases:
        with pytest.raises(Exception) as want:
            jbasis.Basis(arr, **kw)
        with pytest.raises(want.type):
            basis.Basis(arr, **kw)


@pytest.mark.parametrize('btype', ['ggm', 'pauli', 'custom'])
@pytest.mark.parametrize('hermitian', [False, True])
@pytest.mark.parametrize('tidyup', [False, True])
def test_expand_matches_jax(btype, hermitian, tidyup):
    """expand (and Basis.expand) on numpy and on tensors against the
    JAX package on numpy and on device values: within 1e-14 absolute
    (measured <= 1.8e-15, on the unnormalized custom basis)."""
    rng = np.random.default_rng(14)
    if btype == 'custom':
        arr = _custom(rng)
        jb, tb = jbasis.Basis(arr), basis.Basis(arr)
        M = rng.standard_normal((4, 2, 2)) + 1j * rng.standard_normal(
            (4, 2, 2))
    else:
        jb = jbasis.Basis.ggm(3) if btype == 'ggm' else jbasis.Basis.pauli(2)
        tb = convert.basis_from_numpy(jb)
        M = rand_herm(tb.d, 4, rng) if hermitian else \
            rng.standard_normal((4, tb.d, tb.d)) + 0j
    M[0] *= 1e-17
    for normalized in (True, False):
        want = jbasis.expand(M, jb, normalized, hermitian, tidyup)
        got = basis.expand(M, tb, normalized, hermitian, tidyup)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
        want = _jax_np(jbasis.expand(asc(M), jb, normalized, hermitian,
                                     tidyup))
        got = basis.expand(torch.tensor(M), tb, normalized, hermitian,
                           tidyup)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    want = _jax_np(jb.expand(asc(M), hermitian=hermitian, tidyup=tidyup))
    got = tb.expand(torch.tensor(M), hermitian=hermitian, tidyup=tidyup)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


@pytest.mark.parametrize('d', [2, 3, 4])
@pytest.mark.parametrize('traceless', [False, True])
@pytest.mark.parametrize('hermitian', [False, True])
def test_ggm_expand_matches_jax(d, traceless, hermitian):
    """ggm_expand on numpy is JAX's numpy result bit for bit; on tensors
    it holds within 1e-14 of JAX's device result (measured <= 2.5e-16),
    for one matrix and for a stack, and it reconstructs M within 1e-13
    (measured 8.9e-16)."""
    rng = np.random.default_rng(15 + d)
    M = rand_herm(d, 3, rng) if hermitian else \
        rng.standard_normal((3, d, d)) + 1j * rng.standard_normal((3, d, d))
    for m in (M, M[0]):
        want = jbasis.ggm_expand(m, traceless, hermitian)
        np.testing.assert_array_equal(
            basis.ggm_expand(m, traceless, hermitian), want)
        got = basis.ggm_expand(torch.tensor(m), traceless, hermitian)
        want = _jax_np(jbasis.ggm_expand(asc(m), traceless, hermitian))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    coeffs = basis.ggm_expand(torch.tensor(M), hermitian=hermitian)
    rebuilt = torch.einsum('...j,jab->...ab', coeffs.to(torch.complex128),
                           basis.Basis.ggm(d).tensor('cpu'))
    np.testing.assert_allclose(rebuilt.numpy(), M, rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match='square'):
        basis.ggm_expand(np.ones((2, 3)))


@pytest.mark.parametrize('n', [1, 2, 3])
def test_pauli_index_machinery_matches_jax(n):
    """Basis.pauli_mult_table, equivalent_pauli_basis_elements for every
    subset of the qubits, and remap_pauli_basis_elements for every qubit
    permutation equal the JAX package's arrays exactly; the table's
    products are those of the basis elements (1e-15)."""
    from itertools import combinations, permutations
    index, phase = basis.Basis.pauli(n).pauli_mult_table()
    want_index, want_phase = jbasis.Basis.pauli(n).pauli_mult_table()
    np.testing.assert_array_equal(index, want_index)
    np.testing.assert_array_equal(phase, want_phase)
    assert index.dtype == np.int64 and phase.dtype == np.complex128
    b = basis.Basis.pauli(n).np
    prods = np.einsum('aij,bjk->abik', b, b)
    np.testing.assert_allclose(
        prods, phase[..., None, None] / np.sqrt(2**n) * b[index], rtol=0,
        atol=1e-15)
    for k in range(1, n + 1):
        for idx in combinations(range(n), k):
            np.testing.assert_array_equal(
                basis.equivalent_pauli_basis_elements(idx, n),
                jbasis.equivalent_pauli_basis_elements(idx, n))
    np.testing.assert_array_equal(
        basis.equivalent_pauli_basis_elements(n - 1, n),
        jbasis.equivalent_pauli_basis_elements(n - 1, n))
    for order in permutations(range(n)):
        np.testing.assert_array_equal(
            basis.remap_pauli_basis_elements(order, n),
            jbasis.remap_pauli_basis_elements(order, n))
    with pytest.raises(ValueError, match='Pauli'):
        basis.Basis.ggm(2).pauli_mult_table()
