"""The PyTorch port's factored Ozaki contraction (filter_functions_tpu_torch.
ops.ozaki) against the JAX package's int8 / double-single route.

The port runs the JAX package's arithmetic expression for expression:
exact integer digit products and the same float32 recombination.  So
every comparison here is bit-exact, and where a test states a tolerance
it says why.

The Ozaki scales are powers of two, 2^k for integer k.  XLA:CPU's
``exp2`` misses many of them by an ulp (2^3 comes out as 8 + 2^-49 in
float64; in float32, 2^13 and 2^-13 are off too), which moves the JAX
package's digits on this backend, while torch's ``exp2`` is exact there.
The oracle calls therefore run with ``jnp.exp2`` exact at integer
arguments (the ``exact_exp2`` fixture), and the JAX function body runs
unjitted so no trace made that way is cached.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filter_functions_tpu.ops import ozaki as jozaki
from filter_functions_tpu_torch.ops import ozaki


_XLA_EXP2 = jnp.exp2


def _exact_exp2(x):
    """2^x, exact where x is an integer."""
    x = jnp.asarray(x)
    exact = jnp.ldexp(jnp.ones_like(x), x.astype(jnp.int32))
    return jnp.where(x == jnp.round(x), exact, _XLA_EXP2(x))


@pytest.fixture
def exact_exp2(monkeypatch):
    monkeypatch.setattr(jnp, 'exp2', _exact_exp2)


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize('p_dtype', ['float32', 'float64'])
def test_c_outer_forward_matches_jax(p_dtype, exact_exp2):
    """ozaki_matmul_c_outer's forward against the JAX implementation
    with 24-bit truncation, int8 digits, 'ds' recombination and the XLA
    digit pipeline, at M = 64, K = 2048, J = 3, C = 256.  Exact integer
    products and identical float32 recombination: bit-exact."""
    rng = np.random.default_rng(30)
    M, K, J, C = 64, 2048, 3, 256
    P = _complex(rng, (M, K)) * 10.0**rng.integers(-3, 3, (M, 1))
    B = _complex(rng, (K, J)) * np.exp2(rng.integers(-8, 8, (1, J)))
    Cm = _complex(rng, (K, C)) * np.exp2(rng.integers(-8, 8, (1, C)))
    p_re, p_im = (x.astype(p_dtype) for x in (P.real, P.imag))
    args = (p_re, p_im, B.real, B.imag, Cm.real, Cm.imag)
    want_re, want_im = jozaki._ozaki_matmul_c_outer_impl.__wrapped__(
        *map(jnp.asarray, args), 24, 'int8', 'ds', 'xla')
    got_re, got_im = ozaki.ozaki_matmul_c_outer(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), 24)
    np.testing.assert_array_equal(got_re.numpy(), np.asarray(want_re))
    np.testing.assert_array_equal(got_im.numpy(), np.asarray(want_im))
    # and it is a product: 2^-22 of the row-times-column scale, the
    # bound tests/test_cplx.py::test_factored_outer holds JAX to
    want = P.astype(np.complex64 if p_dtype == 'float32' else complex) \
        @ (B[:, :, None] * Cm[:, None, :]).reshape(K, J * C)
    scale = (np.abs(P) @ np.abs((B[:, :, None] * Cm[:, None, :])
                                .reshape(K, J * C))).max()
    got = got_re.numpy() + 1j * got_im.numpy()
    assert np.abs(got - want).max() / scale < 2**-22


def test_c_outer_batch_axis_is_independent():
    """A leading batch axis computes each product on its own (the
    wrapper loops the int8 GEMM over it)."""
    rng = np.random.default_rng(31)
    M, K, J, C = 24, 512, 2, 8
    P = _complex(rng, (2, M, K))
    B = _complex(rng, (2, K, J))
    Cm = _complex(rng, (2, K, C))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    args = (P.real.astype(np.float32), P.imag.astype(np.float32), B.real,
            B.imag, Cm.real, Cm.imag)
    re, im = ozaki.ozaki_matmul_c_outer(*map(t, args))
    for b in range(2):
        r1, i1 = ozaki.ozaki_matmul_c_outer(*(t(a[b]) for a in args))
        assert torch.equal(re[b], r1) and torch.equal(im[b], i1)


def test_c_outer_rejects_shallow_reduction():
    """Like the JAX package, the factored route needs K > 256."""
    x = torch.zeros((24, 256), dtype=torch.float32)
    f = torch.zeros((256, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match='deep K > 256'):
        ozaki.ozaki_matmul_c_outer(x, x, f, f, f, f, 24)


@pytest.mark.parametrize('case', ['f32_cascade', 'f64_int32', 'f64_int64'])
def test_slice_fixed_point_matches_jax(case, exact_exp2):
    """Digit slices and row scales against JAX's int8 slicing: the f32
    cascade (P assembled in float32), the int32 peel (<= 30 bits) and the
    int64 peel (<= 52 bits).  Bit-exact."""
    rng = np.random.default_rng(32)
    x = rng.standard_normal((16, 3328)) * 10.0**rng.integers(-4, 4, (16, 1))
    x[3] = 0.0
    n_slices, sb = {'f32_cascade': (5, 7), 'f64_int32': (4, 7),
                    'f64_int64': (5, 7)}[case]
    x = x.astype(np.float32 if case == 'f32_cascade' else np.float64)
    want_sl, want_sc = jozaki._slice_fixed_point(jnp.asarray(x), -1,
                                                 n_slices, sb, 'int8')
    got_sl, got_sc = ozaki._slice_fixed_point(torch.from_numpy(x),
                                              n_slices, sb)
    assert len(got_sl) == n_slices
    for g, w in zip(got_sl, want_sl):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got_sc.numpy(), np.asarray(want_sc))


def test_slice_params_match_jax():
    """Both slice rules, over the depths and truncation levels the
    package uses (the bf16 rule decides "deep", the int8 rule the digit
    width)."""
    for K in (2, 100, 257, 1024, 2048, 3328, 4096, 16384, 2**17):
        for bits in (24, 30, 52):
            for mxu in ('int8', 'bf16'):
                assert ozaki._slice_params(K, bits, mxu) == \
                    jozaki._slice_params(K, bits, mxu), (K, bits, mxu)
    assert ozaki._slice_params(3328, 24, 'int8') == (7, 4)
    assert ozaki._slice_params(3328, 30, 'bf16')[0] == 6


def test_double_single_helpers_match_jax():
    """_ds_from_int32 splits exactly, _ds_add rounds like JAX's float32
    operations: bit-exact."""
    rng = np.random.default_rng(33)
    v = rng.integers(-2**31, 2**31 - 1, 4096, dtype=np.int32)
    hi, lo = ozaki._ds_from_int32(torch.from_numpy(v))
    whi, wlo = jozaki._ds_from_int32(jnp.asarray(v))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
    assert np.array_equal(hi.numpy().astype(np.int64)
                          + lo.numpy().astype(np.int64), v)
    a = [rng.standard_normal(4096).astype(np.float32) * 2.0**20,
         rng.standard_normal(4096).astype(np.float32)]
    b = [rng.standard_normal(4096).astype(np.float32) * 2.0**-3,
         rng.standard_normal(4096).astype(np.float32) * 2.0**-27]
    got = ozaki._ds_add([torch.from_numpy(x) for x in a],
                        [torch.from_numpy(x) for x in b])
    want = jozaki._ds_add([jnp.asarray(x) for x in a],
                          [jnp.asarray(x) for x in b])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_matmul_from_slices_matches_jax():
    """The int8 level products and their double-single recombination:
    bit-exact against JAX's 'ds' route."""
    rng = np.random.default_rng(34)
    n, sb, M, K, N = 5, 7, 32, 3328, 64
    a_sl = [rng.integers(-64, 65, (1, M, K), dtype=np.int8)
            for _ in range(n)]
    b_sl = [rng.integers(-64, 65, (1, K, N), dtype=np.int8)
            for _ in range(n)]
    got = ozaki._matmul_from_slices([torch.from_numpy(a) for a in a_sl],
                                    [torch.from_numpy(b) for b in b_sl], sb)
    want = jozaki._matmul_from_slices([jnp.asarray(a) for a in a_sl],
                                      [jnp.asarray(b) for b in b_sl], sb, 3,
                                      'ds')
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fix_is_the_23_bit_column_fixed_point():
    """_fix: one power-of-two scale per column shared by re and im, the
    largest magnitude within 2^23 -- the JAX closure's arithmetic,
    written out in numpy."""
    rng = np.random.default_rng(35)
    re = rng.standard_normal((300, 7)) * np.exp2(rng.integers(-9, 9, 7))
    im = rng.standard_normal((300, 7)) * np.exp2(rng.integers(-9, 9, 7))
    im[:, 2] = 0.0
    re[:, 4] = im[:, 4] = 0.0
    zr, zi, e = ozaki._fix(torch.from_numpy(re), torch.from_numpy(im))
    absmax = np.maximum(np.abs(re).max(0), np.abs(im).max(0))
    want_e = np.ceil(np.log2(np.where(absmax > 0, absmax, 1.0)))
    np.testing.assert_array_equal(e.numpy(), want_e)
    np.testing.assert_array_equal(
        zr.numpy(), np.round(re * np.exp2(23 - want_e)).astype(np.int32))
    np.testing.assert_array_equal(
        zi.numpy(), np.round(im * np.exp2(23 - want_e)).astype(np.int32))
    assert np.abs(zr.numpy()).max() <= 2**23


@pytest.mark.parametrize('M, K, N', [(100, 2404, 4), (10, 3328, 4608),
                                     (32, 3328, 64)])
def test_int_mm_batched_takes_every_shape(M, K, N):
    """The int8 level product at shapes that torch._int_mm on CUDA refuses
    (M <= 16, K or N not a multiple of 8: the CPMG-300 train's K = 2404
    against its N = 4 basis columns) is the exact int32 product, with the
    right operand row- or column-major (the kernel's digits are
    K-contiguous); zero padding adds nothing."""
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-64, 65, (2, M, K), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-64, 65, (2, K, N), dtype=np.int8))
    want = a.to(torch.int64) @ b.to(torch.int64)
    for right in (b, b.transpose(-1, -2).contiguous().transpose(-1, -2)):
        got = ozaki._int_mm_batched(a, right)
        assert got.dtype == torch.int32 and got.shape == (2, M, N)
        assert torch.equal(got.to(torch.int64), want)


@pytest.mark.gpu
def test_int_mm_batched_on_card_takes_every_shape():
    """On the card, the padded int8 level product equals the CPU's at the
    shapes torch._int_mm on CUDA refuses unpadded."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: cuBLAS\'s int8 GEMM has no CPU '
                    'mode, the padding is tested above')
    rng = np.random.default_rng(5)
    for M, K, N in [(100, 2404, 4), (10, 3328, 4608), (17, 1000, 12)]:
        a = torch.from_numpy(rng.integers(-64, 65, (2, M, K), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-64, 65, (2, N, K), dtype=np.int8)
                             ).transpose(-1, -2)
        got = ozaki._int_mm_batched(a.cuda(), b.cuda())
        assert torch.equal(got.cpu(), ozaki._int_mm_batched(a, b))
