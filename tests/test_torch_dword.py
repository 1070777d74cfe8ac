"""The PyTorch port's factored-D digit pipeline (filter_functions_tpu_torch.
ops.dword) against the JAX package's Pallas kernel and its XLA digit
arithmetic.

All arithmetic is int32, so every comparison here is bit-exact.  The
CUDA kernel itself runs only on a card: its tests carry the ``gpu``
marker and skip elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filter_functions_tpu.ops import dword_pallas
from filter_functions_tpu_torch.ops import dword, ozaki

#: Kernel-against-plain shapes: (K, J, C, n_d, slice_bits, batch).  The
#: first is the Pallas test shape, the second the flagship's (K = G d^2 =
#: 3328, 18 noise operators, 256 basis elements, 5 digits of 7 bits, the
#: main path's 2 pulses a call), the third a ragged K (K % 16 != 0: byte
#: stores), the fourth a K above the kernel's register cap of 16384, the
#: fifth one flagship pulse alone (the object path's call), the sixth a
#: train of four flagship-sized gates from scratch (52 segments, K =
#: 13312: between 8192 and the cap each thread keeps two runs of words).
SHAPES = {'small': (512, 3, 128, 4, 7, 2),
          'flagship': (3328, 18, 256, 5, 7, 2),
          'ragged': (333, 2, 9, 5, 7, 3),
          'above_cap': (20000, 2, 16, 5, 7, 1),
          'flagship_one': (3328, 18, 256, 5, 7, 1),
          'deep_train': (13312, 18, 256, 5, 7, 1)}


def _factors(K, J, C, seed, batch=None):
    """23-bit signed int32 factors (zbr, zbi, zcr, zci) as numpy."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    mk = lambda n: rng.integers(-2**23, 2**23, lead + (K, n),
                                dtype=np.int32)
    return mk(J), mk(J), mk(C), mk(C)


def _numpy_digits(zbr, zbi, zcr, zci, n_d, slice_bits):
    """numpy copy of tests/test_cplx.py::TestDwordPallas._xla_reference:
    the XLA digit arithmetic of ozaki._ozaki_matmul_c_outer_impl."""
    K, J = zbr.shape
    C = zcr.shape[1]

    def split12(z):
        hi = (z + (1 << 11)) >> 12
        return hi, z - (hi << 12)

    def outer(b1, b0, c1, c0):
        p2 = b1[:, :, None] * c1[:, None, :]
        p1 = (b1[:, :, None] * c0[:, None, :]
              + b0[:, :, None] * c1[:, None, :])
        p0 = b0[:, :, None] * c0[:, None, :]
        return (p2 << 6) + ((p1 + ((p0 + (1 << 11)) >> 12) + (1 << 5)) >> 6)

    sb1, sb0 = split12(zbr)
    si1, si0 = split12(zbi)
    sc1, sc0 = split12(zcr)
    sd1, sd0 = split12(zci)
    w_rr = outer(sb1, sb0, sc1, sc0)
    w_ii = outer(si1, si0, sd1, sd0)
    w_ri = outer(sb1, sb0, sd1, sd0)
    w_ir = outer(si1, si0, sc1, sc0)
    comps = (w_rr - w_ii, w_ri + w_ir, (w_rr - w_ii) + (w_ri + w_ir))
    nbits = n_d * slice_bits
    digits, shifts = [], []
    for w in comps:
        w = w.reshape(K, J * C)
        colmax = np.abs(w).max(0)
        e_w = np.ceil(np.log2(np.maximum(colmax, 1).astype(
            np.float64))).astype(np.int32)
        shift = min(nbits, 30) - 1 - e_w
        ls = np.maximum(shift, 0)[None, :]
        rs = np.maximum(-shift, 0)[None, :]
        half = (np.int32(1) << rs) >> 1
        z = ((w << ls) + half) >> rs
        sl = []
        for k in range(n_d - 1, 0, -1):
            sh = slice_bits * k
            d = (z + (1 << (sh - 1))) >> sh
            sl.append(d.astype(np.int8))
            z = z - (d << sh)
        sl.append(z.astype(np.int8))
        digits.append(np.stack(sl))
        shifts.append(shift)
    return np.stack(digits), np.stack(shifts)


def _reference(factors, n_d, slice_bits):
    """The port's plain version on one (unbatched) factor set."""
    digits, shifts = dword.dword_digits_reference(
        *(torch.from_numpy(f)[None] for f in factors), n_d, slice_bits)
    return digits[0].numpy(), shifts[0].numpy()


@pytest.mark.parametrize('n_d', [4, 5])
def test_reference_matches_pallas_interpret(n_d):
    """Bit-exact against the Pallas kernel run in interpret mode, as
    tests/test_cplx.py runs it on the CPU."""
    if not dword_pallas._HAVE_PALLAS:
        pytest.skip('pallas unavailable')
    K, J, C = 512, 3, 128
    factors = _factors(K, J, C, seed=16)
    want_d, want_s = dword_pallas.dword_digits(
        *(jnp.asarray(f) for f in factors), n_d=n_d, slice_bits=7,
        interpret=jax.default_backend() == 'cpu')
    got_d, got_s = _reference(factors, n_d, 7)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


def test_reference_matches_xla_arithmetic_flagship_shape():
    """Bit-exact against the XLA digit arithmetic at the flagship shape,
    with one all-zero C column: its J columns of D are zero, their bit
    length is 0 and their shift the full top bit, 29."""
    K, J, C, n_d, sb, _ = SHAPES['flagship']
    zbr, zbi, zcr, zci = _factors(K, J, C, seed=17)
    zcr[:, 5] = 0
    zci[:, 5] = 0
    want_d, want_s = _numpy_digits(zbr, zbi, zcr, zci, n_d, sb)
    got_d, got_s = _reference((zbr, zbi, zcr, zci), n_d, sb)
    zero_cols = np.arange(J) * C + 5
    assert (want_s[:, zero_cols] == 29).all()
    assert not got_d[:, :, :, zero_cols].any()
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_d, want_d)


def test_reference_digits_reconstruct_the_words():
    """The digits, weighted by 2^(slice_bits s), rebuild the normalized
    words; every column's top digit is nonzero unless the column is."""
    K, J, C, n_d, sb = 64, 2, 8, 5, 7
    factors = _factors(K, J, C, seed=18)
    digits, shifts = _reference(factors, n_d, sb)
    weights = 2**(sb * np.arange(n_d - 1, -1, -1, dtype=np.int64))
    v = np.tensordot(weights, digits.astype(np.int64), axes=(0, 1))
    assert (np.abs(v) < 2**30).all()
    assert (np.abs(v).max(1) >= 2**(min(n_d * sb, 30) - 2)).all()
    assert shifts.dtype == np.int32 and shifts.shape == (3, J * C)


def test_wrapper_on_cpu_takes_plain_version_in_gemm_layout():
    """CPU tensors go to the plain version; the wrapper's digits are the
    (J C, K) planes the int8 GEMM reads, and no kernel launch counts."""
    K, J, C, n_d, sb = 256, 3, 16, 5, 7
    factors = [torch.from_numpy(f) for f in _factors(K, J, C, seed=19,
                                                     batch=2)]
    before = dword.launches
    digits, shifts = dword.dword_digits(*factors, n_d, sb)
    want_d, want_s = dword.dword_digits_reference(*factors, n_d, sb)
    assert dword.launches == before
    assert digits.shape == (2, 3, n_d, J * C, K)
    assert torch.equal(digits, want_d.transpose(-1, -2))
    assert torch.equal(shifts, want_s)


def test_reference_batch_axis_is_independent():
    """A leading batch axis computes each factor set on its own."""
    K, J, C, n_d, sb = 128, 2, 8, 5, 7
    factors = _factors(K, J, C, seed=20, batch=3)
    digits, shifts = dword.dword_digits_reference(
        *(torch.from_numpy(f) for f in factors), n_d, sb)
    for b in range(3):
        want_d, want_s = _reference([f[b] for f in factors], n_d, sb)
        np.testing.assert_array_equal(digits[b].numpy(), want_d)
        np.testing.assert_array_equal(shifts[b].numpy(), want_s)


def test_single_product_word_matches_split_word():
    """The CUDA kernel's word, one 64-bit product (int64(zB) zC + 2^17 +
    2^11) >> 18, equals the plain version's 12-bit split word bit for bit
    on seeded factors in [-2^23, 2^23] and at the four corners +-2^23,
    where |w| reaches its maximum 2^28."""
    rng = np.random.default_rng(22)
    corners = np.array([[2**23, 2**23], [2**23, -2**23], [-2**23, 2**23],
                        [-2**23, -2**23]])
    zb, zc = np.concatenate(
        [rng.integers(-2**23, 2**23, (10**6, 2), endpoint=True), corners]).T
    tb, tc = (torch.from_numpy(z.astype(np.int32))[:, None] for z in (zb, zc))
    split = dword._outer_word(*dword._split12(tb), *dword._split12(tc))
    single = (torch.from_numpy(zb) * torch.from_numpy(zc)
              + (1 << 17) + (1 << 11)) >> 18
    assert torch.equal(split[:, 0, 0].long(), single)
    assert single.abs().max().item() == 2**28
    assert (single[-4:].abs() == 2**28).all()


def test_fix_factors_lie_in_the_kernel_domain():
    """ops.ozaki._fix rounds its factors into [-2^23, 2^23], the domain of
    the kernel's single-product word: a column whose max is an exact
    power of two reaches 2^23 itself, one just above a power of two
    stays inside."""
    rng = np.random.default_rng(23)
    scale = 10.0**rng.integers(-6, 6, (1, 1, 8))
    scale[..., :2] = 1.0
    re = rng.standard_normal((2, 64, 8)) * scale
    im = rng.standard_normal((2, 64, 8)) * scale
    re[:, :, 0], im[:, :, 0] = re[:, :, 0] * 1e-3, im[:, :, 0] * 1e-3
    re[0, 5, 0], im[1, 9, 0] = 4.0, -0.25
    re[:, :, 1] = np.clip(re[:, :, 1], -0.1, 0.1)
    im[:, :, 1] = np.clip(im[:, :, 1], -0.1, 0.1)
    re[0, 7, 1] = -0.125 * (1 + 2.0**-52)
    im[1, 2, 1] = 0.125 * (1 + 2.0**-40)
    zr, zi, e = ozaki._fix(torch.from_numpy(re), torch.from_numpy(im))
    assert zr.dtype == zi.dtype == torch.int32
    assert max(zr.abs().max().item(), zi.abs().max().item()) <= 2**23
    assert zr[0, 5, 0].item() == 2**23 and zi[1, 9, 0].item() == -2**23
    assert zr[0, 7, 1].abs().item() <= 2**23
    assert zi[1, 2, 1].abs().item() <= 2**23


@pytest.mark.parametrize('bad', ['dtype', 'rank', 'shape', 'layout'])
def test_wrapper_rejects_bad_input(bad):
    """The wrapper checks type, rank, shapes and the digit layout before
    anything runs."""
    f = [torch.zeros((1, 64, 2), dtype=torch.int32),
         torch.zeros((1, 64, 2), dtype=torch.int32),
         torch.zeros((1, 64, 8), dtype=torch.int32),
         torch.zeros((1, 64, 8), dtype=torch.int32)]
    n_d, sb = 5, 7
    if bad == 'dtype':
        f[0] = f[0].to(torch.int64)
    elif bad == 'rank':
        f[2] = f[2][0]
    elif bad == 'shape':
        f[3] = torch.zeros((1, 32, 8), dtype=torch.int32)
    else:
        n_d, sb = 6, 7
    with pytest.raises((TypeError, ValueError)):
        dword.dword_digits(*f, n_d, sb)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode, its '
                    'plain version is tested above')
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_kernel_matches_reference_on_card(shape, cuda_device):
    """The CUDA kernel is bit-exact against the plain version on the
    card."""
    K, J, C, n_d, sb, batch = SHAPES[shape]
    factors = [torch.from_numpy(f).to(cuda_device)
               for f in _factors(K, J, C, seed=21, batch=batch)]
    before = dword.launches
    digits, shifts = dword.dword_digits(*factors, n_d, sb)
    torch.cuda.synchronize()
    want_d, want_s = dword.dword_digits_reference(*factors, n_d, sb)
    assert dword.launches == before + 1
    assert torch.equal(shifts, want_s)
    assert torch.equal(digits, want_d.transpose(-1, -2))
