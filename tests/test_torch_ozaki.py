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
from filter_functions_tpu_torch import numeric, tracing
from filter_functions_tpu_torch.ops import dword, ozaki, products
from torch_testutil import products_inputs


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
    """The int8 slice rule over the depths and truncation levels the
    package uses, and the deep regime (numeric._is_deep) against the JAX
    package's bf16 rule, which decides "deep" by 5- or 6-bit slices."""
    for K in (2, 100, 257, 1024, 1025, 2048, 3328, 4096, 16384, 16385,
              2**17):
        for bits in (24, 30, 52):
            assert ozaki._slice_params(K, bits) == \
                jozaki._slice_params(K, bits, 'int8'), (K, bits)
        assert numeric._is_deep(K) == \
            (jozaki._slice_params(K, 30, 'bf16')[0] in (5, 6)), K
    assert ozaki._slice_params(3328, 24) == (7, 4)


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


# The slice products of a call: ops.ozaki._outer_contract takes the kernel
# of ops.products on CUDA tensors and the composite _outer_contract_plain
# on the CPU.

@pytest.mark.parametrize('slice_bits', [5, 6, 7])
def test_outer_contract_on_cpu_takes_the_plain_version(slice_bits):
    """CPU tensors take the composite: the same bits, no kernel launch."""
    args = products_inputs(2, 20, 256, 24, slice_bits, 'cpu',
                                      slice_bits)
    before = products.launches
    got = ozaki._outer_contract(*args, slice_bits)
    want = ozaki._outer_contract_plain(*args, slice_bits)
    assert products.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].dtype == torch.float64 and got[0].shape == (2, 20, 24)


def _spoil(case):
    """A call of _outer_contract with one thing wrong, and the error."""
    *sides, outs = products_inputs(1, 8, 64, 8, 7, 'cpu', 0)
    (pr, sc), rest = sides[0], sides[1:]
    if case == 'slice dtype':
        pr = [pr[0].to(torch.int16)] + pr[1:]
        return [(pr, sc), *rest], outs, 7, TypeError
    if case == 'scale dtype':
        return [(pr, sc.to(torch.float16)), *rest], outs, 7, TypeError
    if case == 'mixed scale dtypes':
        return [(pr, sc.double()), *rest], outs, 7, TypeError
    if case == 'd scale dtype':
        d_sl, d_sc = outs[1]
        return sides, [outs[0], (d_sl, d_sc.float()), outs[2]], 7, TypeError
    if case == 'device mix':
        return [(pr, sc.to('meta')), *rest], outs, 7, ValueError
    if case == 'shape':
        pr = [pr[0][:, :4]] + pr[1:]
        return [(pr, sc), *rest], outs, 7, ValueError
    if case == 'slice count':
        return [(pr[:4], sc), *rest], outs, 7, ValueError
    if case == 'slice bits':
        return sides, outs, 8, ValueError
    if case == 'two D sides':
        return sides, outs[:2], 7, ValueError
    raise AssertionError(case)


@pytest.mark.parametrize('case', ['slice dtype', 'scale dtype',
                                  'mixed scale dtypes', 'd scale dtype',
                                  'device mix', 'shape', 'slice count',
                                  'slice bits', 'two D sides'])
def test_outer_contract_rejects_what_the_kernel_does_not_take(case):
    """The wrapper checks its arguments on every device, before either
    version runs: a wrong dtype, P scales of two dtypes, a device mix, a
    shape that disagrees, a
    slice count other than the route's ceil(30 / slice_bits), a slice
    width outside 5..7."""
    sides, outs, slice_bits, error = _spoil(case)
    with pytest.raises(error):
        ozaki._outer_contract(*sides, outs, slice_bits)


def test_products_launch_needs_a_card():
    """The launch itself takes CUDA tensors only: no fallback."""
    args = products_inputs(1, 8, 64, 8, 7, 'cpu', 0)
    with pytest.raises(ValueError, match='CUDA'):
        products.ozaki_products(*args, 7, 5)


@pytest.mark.parametrize('B, M, K, N, slice_bits',
                         [(2, 24, 512, 40, 7), (1, 10, 2416, 4, 5)])
def test_int8_ops_counts_the_logical_products(B, M, K, N, slice_bits):
    """tracing.counts['ozaki.int8_ops'] rises by 3 B sum_pairs 2 M K N a
    call: n (n + 1) / 2 slice pairs of the n = ceil(30 / slice_bits)
    levels, unpadded."""
    args = products_inputs(B, M, K, N, slice_bits, 'cpu', K)
    n = -(-30 // slice_bits)
    before = tracing.counts['ozaki.int8_ops']
    ozaki._outer_contract(*args, slice_bits)
    assert tracing.counts['ozaki.int8_ops'] - before == \
        3 * B * (n * (n + 1) // 2) * 2 * M * K * N


#: Shapes of the slice products the port makes on the card: the cells'
#: chunk, the object path's G-chunked depth, sequencing.extend's
#: crosstalk rows, the sharded entries' omega shards, the qft example,
#: the CPMG-300 train (K = 2404, whose rows the wrapper pads to 16
#: bytes), and slice widths 5 and 6 on small synthetic depths.
CARD_SHAPES = {
    'cells_chunk': (2, 1000, 3328, 4608, 7),
    'object_path': (1, 1000, 13312, 4608, 7),
    'extend_crosstalk': (1, 1000, 3328, 768, 7),
    'sharded_2': (2, 500, 3328, 4608, 7),
    'sharded_4': (2, 250, 3328, 4608, 7),
    'qft_example': (1, 500, 3328, 4608, 7),
    'cpmg_300': (1, 100, 2404, 4, 7),
    'slice_bits_6': (2, 130, 1024, 200, 6),
    'slice_bits_5': (1, 70, 512, 130, 5),
}


@pytest.mark.gpu
@pytest.mark.parametrize('name', list(CARD_SHAPES))
def test_products_kernel_is_bit_exact_on_card(name):
    """On the card the kernel equals the composite bit for bit (its int32
    levels, double-single recombination, widening, scaling and Gauss
    combination), in one launch a call; and with float64 row scales."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the slice-products kernel has no '
                    'CPU mode; the wrapper is tested above')
    B, M, K, N, slice_bits = CARD_SHAPES[name]
    for p_dtype in (torch.float32, torch.float64):
        args = products_inputs(B, M, K, N, slice_bits, 'cuda',
                                          M + K, p_dtype)
        want = ozaki._outer_contract_plain(*args, slice_bits)
        before = products.launches
        got = ozaki._outer_contract(*args, slice_bits)
        torch.cuda.synchronize()
        assert products.launches - before == 1
        for g, w in zip(got, want):
            assert g.shape == (B, M, N) and torch.equal(g, w), name


@pytest.mark.gpu
def test_products_kernel_on_the_routes_operands():
    """The whole factored forward on the card: P sliced, D's digits from
    dword_digits, the products from the kernel, against the same operands
    through the composite; one launch of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    rng = np.random.default_rng(36)
    M, K, J, C = 300, 3328, 3, 256
    P = _complex(rng, (M, K)) * 10.0**rng.integers(-3, 3, (M, 1))
    B = _complex(rng, (K, J)) * np.exp2(rng.integers(-8, 8, (1, J)))
    Cm = _complex(rng, (K, C)) * np.exp2(rng.integers(-8, 8, (1, C)))
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (P.real.astype(np.float32), P.imag.astype(np.float32),
                      B.real, B.imag, Cm.real, Cm.imag)]
    calls = []
    plain = ozaki._outer_contract_plain

    def spy(*a):
        calls.append(a)
        return plain(*a)

    before = (dword.launches, products.launches)
    got = ozaki.ozaki_matmul_c_outer(*args, 24)
    torch.cuda.synchronize()
    assert (dword.launches - before[0], products.launches - before[1]) \
        == (1, 1)
    ozaki._outer_contract_plain = spy
    try:
        re, im = ozaki._ozaki_outer_forward(*args, 24)
    finally:
        ozaki._outer_contract_plain = plain
    assert not calls        # CUDA tensors never take the composite
    want = plain(*_route_operands(args))
    for g, r, w in zip(got, (re, im), want):
        assert torch.equal(g, r) and torch.equal(g, w[0])


def _route_operands(args):
    """The operands _ozaki_outer_forward hands _outer_contract, for a
    single (M, K) product: (pr, pi, ps, outs, slice_bits)."""
    p_re, p_im, b_re, b_im, c_re, c_im = (a[None] for a in args)
    K = p_re.shape[-1]
    slice_bits, n_p = ozaki._slice_params(K, 24)
    n_d = -(-30 // slice_bits)
    n_p = max(n_p, n_d)
    pr = ozaki._slice_fixed_point(p_re, n_p, slice_bits)
    pi = ozaki._slice_fixed_point(p_im, n_p, slice_bits)
    ps = ozaki._slice_fixed_point(p_re + p_im, n_p, slice_bits)
    zbr, zbi, eb = ozaki._fix(b_re, b_im)
    zcr, zci, ec = ozaki._fix(c_re, c_im)
    J, Cc = b_re.shape[-1], c_re.shape[-1]
    e_bc = (eb[..., :, None] + ec[..., None, :]).reshape(-1, J * Cc)
    digits, dshifts = dword.dword_digits(zbr, zbi, zcr, zci, n_d,
                                         slice_bits)
    outs = [([digits[:, t, s].transpose(-1, -2) for s in range(n_d)],
             torch.exp2((e_bc - 28 - dshifts[:, t] + (n_d - 1) * slice_bits)
                        .to(torch.float64))[..., None, :])
            for t in range(3)]
    return pr, pi, ps, outs, slice_bits
