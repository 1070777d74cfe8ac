"""The PyTorch port's utilities (filter_functions_tpu_torch.util, .types,
.config.memory_budget) against the JAX package's, on the same numpy
inputs.

Host-side helpers (identifiers, hashing, sample frequencies, dot_HS,
oper_equiv) run the JAX package's numpy arithmetic and are compared for
equality; the tensor helpers (integrate, mdot, tensor) within 1e-14.
"""
import numpy as np
import pytest
import torch

from filter_functions_tpu import util as jutil
from filter_functions_tpu_torch import config, types, util
from testutil import rand_herm, rand_pulse_sequence, rand_unit


def _t(x):
    return torch.tensor(np.asarray(x))


class _FakeQobj:
    def __init__(self, a):
        self.a = np.asarray(a, dtype=complex)

    def full(self):
        return self.a


class _FakeQopt:
    def __init__(self, a):
        self.data = np.asarray(a, dtype=complex)

    def dexp(self):
        pass


def test_paulis_and_duck_typed_operators():
    """paulis is the JAX package's array; parse_operators takes tensors,
    numpy arrays, qutip-like and qopt-like objects to the same host
    array as JAX does (bit-identical)."""
    np.testing.assert_array_equal(util.paulis, jutil.paulis)
    X = util.paulis[1]
    ops = [X, _FakeQobj(X), _FakeQopt(X)]
    got = util.parse_operators(ops + [_t(X)], 'test')
    np.testing.assert_array_equal(got[:3], jutil.parse_operators(ops, 'test'))
    np.testing.assert_array_equal(got[3], X)


@pytest.mark.parametrize('bad', [
    [object()],                       # not an operator
    [np.zeros((2, 3))],               # not square
    [np.zeros((2, 2, 2, 2))],         # more than two dimensions
])
def test_parse_operators_raises_like_jax(bad):
    """The same bad operators raise the same exception type."""
    with pytest.raises(Exception) as want:
        jutil.parse_operators(bad, 'test')
    with pytest.raises(want.type, match='test'):
        util.parse_operators(bad, 'test')


_OMEGA = np.linspace(1, 2, 10)
_CROSS = np.ones((2, 2, 10)) + 0j
_CROSS[0, 1], _CROSS[1, 0] = 1j, -1j
_BAD_CROSS = _CROSS.copy()
_BAD_CROSS[0, 1] = 2j


@pytest.mark.parametrize('spectrum', [np.ones(10), 2 * np.ones((2, 10)),
                                      _CROSS, np.ones((1, 10))],
                         ids=['shared', 'per-operator', 'cross', 'broadcast'])
def test_parse_spectrum_matches_jax(spectrum):
    """Valid spectra broadcast to the JAX package's shape and values, from
    numpy and from a tensor, which keeps its device and dtype."""
    want = jutil.parse_spectrum(spectrum, _OMEGA, [0, 1])
    got = util.parse_spectrum(spectrum, _t(_OMEGA), [0, 1])
    assert got.dtype == (torch.complex128 if np.iscomplexobj(spectrum)
                         else torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)
    got = util.parse_spectrum(_t(spectrum), _t(_OMEGA), [0, 1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('spectrum', [np.ones((3, 10)), np.ones(9),
                                      np.ones((2, 2, 2, 10)), _BAD_CROSS],
                         ids=['operators', 'frequencies', 'ndim-4',
                              'not-hermitian'])
def test_parse_spectrum_raises_like_jax(spectrum):
    """Bad spectra raise the JAX package's exception type, as numpy and
    as tensors."""
    with pytest.raises(Exception) as want:
        jutil.parse_spectrum(spectrum, _OMEGA, [0, 1])
    for given in (spectrum, _t(spectrum)):
        with pytest.raises(want.type):
            util.parse_spectrum(given, _t(_OMEGA), [0, 1])


def test_identifier_helpers_match_jax():
    """Indices, the invalid-identifier error, sequence detection and the
    optional-parameter decorator behave as in the JAX package."""
    ids = np.array(['a', 'c', 'b'])
    for sel in (None, 'b', ['c', 'a']):
        np.testing.assert_array_equal(
            util.get_indices_from_identifiers(ids, sel),
            jutil.get_indices_from_identifiers(ids, sel))
    with pytest.raises(ValueError, match='Invalid identifiers'):
        util.get_indices_from_identifiers(ids, ['x'])
    for obj in ([1], 'ab', np.arange(2), _t([1.0]), 1.0, iter([1])):
        assert util.is_sequence_like(obj) == jutil.is_sequence_like(obj)

    @util.parse_optional_parameters(which=('a', 'b'), n=(1, 2))
    def f(x, which='a', n=1):
        return which, n

    assert f(0) == ('a', 1) and f(0, 'b', 2) == ('b', 2)
    with pytest.raises(ValueError, match='Invalid value for which'):
        f(0, which='c')
    with pytest.raises(ValueError, match='Should be one of'):
        f(0, 'a', 3)


@pytest.mark.parametrize('spacing', ['log', 'linear'])
@pytest.mark.parametrize('quasistatic', [False, True])
def test_get_sample_frequencies_matches_jax(spacing, quasistatic):
    """The default grid of a pulse equals the JAX package's bit for bit
    (host numpy on both sides); a bad spacing raises ValueError."""
    pulse = rand_pulse_sequence(2, 5, local_rng=np.random.default_rng(3))
    kw = dict(n_samples=50, spacing=spacing,
              include_quasistatic=quasistatic)
    np.testing.assert_array_equal(util.get_sample_frequencies(pulse, **kw),
                                  jutil.get_sample_frequencies(pulse, **kw))
    with pytest.raises(ValueError):
        util.get_sample_frequencies(pulse, spacing='foo')


def test_integrate_mdot_tensor_match_jax():
    """integrate (with x, or with dx=), mdot along an axis and the tensor
    product agree with JAX within 1e-14 (measured <= 3.4e-16: numpy
    operands give JAX's numpy result exactly, tensors sum in torch's
    order)."""
    rng = np.random.default_rng(4)
    f = rng.standard_normal((3, 20)) + 1j * rng.standard_normal((3, 20))
    x = np.sort(rng.random(20))
    np.testing.assert_allclose(util.integrate(_t(f), _t(x)).numpy(),
                               jutil.integrate(f, x), rtol=0, atol=1e-14)
    np.testing.assert_allclose(util.integrate(_t(f), dx=0.3).numpy(),
                               jutil.integrate(f, dx=0.3), rtol=0,
                               atol=1e-14)
    mats = rand_unit(3, 4, rng)
    stack = np.stack([mats, mats[::-1]], 1)               # (4, 2, 3, 3)
    for axis, arr in ((0, mats), (0, stack), (1, stack.swapaxes(0, 1))):
        want = jutil.mdot(arr, axis)
        np.testing.assert_allclose(util.mdot(_t(arr), axis).numpy(), want,
                                   rtol=0, atol=1e-14)
        np.testing.assert_allclose(util.mdot(arr, axis), want, rtol=0,
                                   atol=1e-14)
    a, b = rand_herm(2, 3, rng), rand_herm(3, 1, rng)
    want = jutil.tensor(a, b, util.paulis[1])
    np.testing.assert_allclose(util.tensor(a, b, util.paulis[1]), want,
                               rtol=0, atol=1e-14)
    got = util.tensor(_t(a), b, util.paulis[1])
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match='Incompatible shapes'):
        util.tensor(np.ones((2, 2, 2)), np.ones((3, 2, 2)))


def test_dot_hs_oper_equiv_abs2_match_jax():
    """dot_HS, oper_equiv and abs2 give the JAX package's values, for
    numpy and tensor operands."""
    rng = np.random.default_rng(5)
    u, v = rand_unit(3, 2, rng)
    for U, V in ((u, v), (u, u * np.exp(0.3j))):
        assert util.dot_HS(U, V) == jutil.dot_HS(U, V)
        assert util.dot_HS(_t(U), _t(V)) == jutil.dot_HS(U, V)
        assert util.oper_equiv(_t(U), V) == jutil.oper_equiv(U, V)
    x = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    np.testing.assert_array_equal(util.abs2(_t(x)).numpy(), jutil.abs2(x))
    np.testing.assert_array_equal(util.abs2(x.real), jutil.abs2(x.real))
    a = rng.standard_normal((3, 4)) * np.array([1, 1e-17, 1, 1e-20])
    np.testing.assert_array_equal(util.remove_float_errors(_t(a)).numpy(),
                                  jutil.remove_float_errors(a.copy()))
    np.testing.assert_array_equal(util.remove_float_errors(a.copy(), 10),
                                  jutil.remove_float_errors(a.copy(), 10))


def test_hashing_and_progressbar_match_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((3, 4))
    a[0, 0] = -0.0
    assert util.hash_array_along_axis(a, 1) == \
        jutil.hash_array_along_axis(a, 1)
    for seq in ([a] * 3, [a, a.copy()], [a, a + 1]):
        assert util.all_array_equal(seq) == jutil.all_array_equal(seq)
    assert list(util.progressbar_range(3)) == [0, 1, 2]
    assert list(util.progressbar_range(3, show_progressbar=True)) == \
        [0, 1, 2]


def test_memory_budget(monkeypatch):
    """The budget is budget_bytes when given, else 2 GiB off CUDA, or an
    eighth of the card's memory clamped to [64 MiB, 4 GiB], as the JAX
    package's memory_budget."""
    assert config.memory_budget('cpu') == 2 << 30
    assert config.memory_budget('cpu', budget_bytes=1234) == 1234
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda device: (0, 80 << 30))
    assert config.memory_budget('cuda') == 4 << 30
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda device: (0, 16 << 30))
    assert config.memory_budget('cuda') == 2 << 30
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda device: (0, 256 << 20))
    assert config.memory_budget('cuda') == 64 << 20


def test_types_are_structural():
    """The aliases exist and mention no optional dependency."""
    for name in ('Coefficients', 'Operator', 'State', 'Hamiltonian',
                 'PulseMapping', 'Device'):
        assert hasattr(types, name)
    assert 'qutip' not in repr(types.Operator)


# -----------------------------------------------------------------------------
# tensor_insert / tensor_merge / tensor_transpose
# -----------------------------------------------------------------------------
def _tensor_cases():
    """(name, call(util module, array converter)) of the tensor-family
    cases of tests/test_util.py::TestTensor."""
    rng = np.random.default_rng(21)
    I, X, Y, Z = jutil.paulis
    d22, d2 = [[2, 2], [2, 2]], [[2] * 2] * 2
    arrs, args = rng.standard_normal((2, 2, 2)), rng.standard_normal((2, 2, 2))
    A1, B1 = rng.standard_normal((2, 2, 3, 1, 2))
    C1 = rng.standard_normal((3, 1, 3))
    A3, C3 = rng.standard_normal((2, 3, 1, 2)), rng.standard_normal((3, 2, 1))
    B3 = rng.standard_normal((2, 3, 2, 2))
    a = rng.standard_normal((2, 10, 3, 4))
    b = rng.standard_normal((2, 10, 3, 2))
    stack = rng.standard_normal((5, 4, 2, 2, 2))
    cases = {
        'insert_pos0': lambda u, t: u.tensor_insert(
            t(jutil.tensor(X, I)), t(Y), t(Z), pos=0, arr_dims=d22),
        'insert_pos1': lambda u, t: u.tensor_insert(
            t(jutil.tensor(X, I)), t(Y), t(Z), pos=1, arr_dims=d22),
        'insert_pos2': lambda u, t: u.tensor_insert(
            t(jutil.tensor(X, I)), t(Y), t(Z), pos=2, arr_dims=d22),
        'insert_neg': lambda u, t: u.tensor_insert(
            t(jutil.tensor(X, I)), t(Y), t(Z), pos=-1, arr_dims=d22),
        'insert_multi': lambda u, t: u.tensor_insert(
            t(jutil.tensor(*arrs)), *map(t, args), pos=(0, 1), arr_dims=d22),
        'insert_duplicate': lambda u, t: u.tensor_insert(
            t(jutil.tensor(*arrs)), *map(t, args), pos=(0, 0), arr_dims=d22),
        'insert_1_2': lambda u, t: u.tensor_insert(
            t(jutil.tensor(*arrs)), *map(t, args), pos=(1, 2), arr_dims=d22),
        'insert_rank1': lambda u, t: u.tensor_insert(
            t(jutil.tensor(A1, C1, rank=1)), t(B1), pos=1, rank=1,
            arr_dims=[[2, 3]]),
        'insert_rank3': lambda u, t: u.tensor_insert(
            t(jutil.tensor(A3, C3, rank=3)), t(B3), pos=1, rank=3,
            arr_dims=[[3, 3], [1, 2], [2, 1]]),
        'insert_rank3_stack': lambda u, t: u.tensor_insert(
            t(jutil.tensor(*stack[2:], rank=3)), *map(t, stack[:2]), pos=1,
            rank=3, arr_dims=[[2] * 3] * 3),
        'merge': lambda u, t: u.tensor_merge(
            t(jutil.tensor(X, Y, Z)), t(jutil.tensor(I, I)), pos=[1, 2],
            arr_dims=[[2] * 3] * 2, ins_dims=d2),
        'merge_swapped': lambda u, t: u.tensor_merge(
            t(jutil.tensor(I, I)), t(jutil.tensor(X, Y, Z)), pos=[0, 1, 2],
            arr_dims=d2, ins_dims=[[2] * 3] * 2),
        'merge_duplicate': lambda u, t: u.tensor_merge(
            t(jutil.tensor(Y, Z)), t(jutil.tensor(I, X)), pos=[0, 0],
            arr_dims=d2, ins_dims=d2),
        'merge_neg': lambda u, t: u.tensor_merge(
            t(jutil.tensor(Y, Z)), t(jutil.tensor(I, X)), pos=(-1, -2),
            arr_dims=d2, ins_dims=d2),
        'merge_rank1': lambda u, t: u.tensor_merge(
            t(jutil.tensor(*a, rank=1)), t(jutil.tensor(*b, rank=1)),
            pos=[0, 1], arr_dims=[[4, 4]], ins_dims=[[2, 2]], rank=1),
        'transpose': lambda u, t: u.tensor_transpose(
            t(jutil.tensor(X, Y, Z)), [1, 2, 0], [[2, 2, 2]] * 2),
        'transpose_rank1': lambda u, t: u.tensor_transpose(
            t(jutil.tensor(*stack[:3, 0, 0, 0], rank=1)), [2, 0, 1],
            [[2] * 3], rank=1),
        'transpose_batch': lambda u, t: u.tensor_transpose(
            t(jutil.tensor(*stack[:3, :, 0], rank=2)), (0, 2, 1),
            [[2] * 3] * 2),
    }
    return cases


@pytest.mark.parametrize('name', list(_tensor_cases()))
def test_tensor_family_matches_jax(name):
    """tensor_insert, tensor_merge and tensor_transpose on the cases of
    tests/test_util.py: numpy in gives JAX's numpy result bit for bit; a
    tensor in gives a tensor of the same dtype with the same entries
    (each entry is one product, so exact too)."""
    call = _tensor_cases()[name]
    want = call(jutil, np.asarray)
    got = call(util, np.asarray)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    got = call(util, torch.tensor)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.tensor(
        want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_tensor_family_mixed_operands_and_errors():
    """numpy factors join a tensor's device and dtype; the same bad
    arguments raise what JAX's raise."""
    I, X, Y, Z = util.paulis
    got = util.tensor_insert(torch.tensor(util.tensor(X, I)), Y, pos=0,
                             arr_dims=[[2, 2], [2, 2]])
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), util.tensor(Y, X, I))
    eigvals = torch.tensor([1.0, -1.0])
    got = util.tensor_insert(eigvals, *np.ones((2, 2)), pos=[0, 1], rank=1,
                             arr_dims=[[2]])
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.kron(np.ones(2), np.kron(
        [1.0, -1.0], np.ones(2))))
    bad = [
        (lambda u: u.tensor_insert(u.tensor(X, I), pos=0,
                                   arr_dims=[[2, 2], [2, 2]]), ValueError),
        (lambda u: u.tensor_insert(u.tensor(X, I), Y, pos=5,
                                   arr_dims=[[2, 2], [2, 2]]), IndexError),
        (lambda u: u.tensor_insert(u.tensor(X, I), Y, Z, pos=(0, 1, 2),
                                   arr_dims=[[2, 2], [2, 2]]), ValueError),
        (lambda u: u.tensor_insert(u.tensor(X, I), Y, pos=1, rank=1,
                                   arr_dims=[[3, 3], [1, 2], [2, 1]]),
         ValueError),
        (lambda u: u.tensor_merge(u.tensor(X, Y), u.tensor(I, I), pos=(1, 2),
                                  arr_dims=[[2, 2]] * 3,
                                  ins_dims=[[2, 2]] * 2), ValueError),
        (lambda u: u.tensor_merge(u.tensor(X, Y), u.tensor(I, I), pos=(1, 3),
                                  arr_dims=[[2, 2]] * 2,
                                  ins_dims=[[2, 2]] * 2), IndexError),
        (lambda u: u.tensor_merge(u.tensor(X, Y), u.tensor(I, I), pos=(1, 2),
                                  arr_dims=[[2, 3], [2, 2]],
                                  ins_dims=[[2, 2]] * 2), ValueError),
        (lambda u: u.tensor_transpose(u.tensor(X, Y), [0, 0], [[2, 2]] * 2),
         ValueError),
        (lambda u: u.tensor_transpose(u.tensor(X, Y), [0, 1.0], [[2, 2]] * 2),
         TypeError),
    ]
    for call, exc in bad:
        with pytest.raises(exc) as want:
            call(jutil)
        with pytest.raises(exc) as got:
            call(util)
        assert str(got.value) == str(want.value)
