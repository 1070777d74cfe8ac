"""The PyTorch port's second-order term from the separable tables of
the K2 lattice (``numeric._second_order_factored_single``): the tables,
and the frequency shifts and second-order filter function built from
them, which the port computes without the (n_w, d^4) lattice wherever
it does not cache it.

The oracle is the JAX package's factored route, run eagerly with
``FF_TPU_SO_FACTORED=1`` as tests/test_core.py::
TestSecondOrderFactoredRoute runs it, and the port's own lattice, which
it builds only for ``cache_intermediates`` (``numeric.
_second_order_steps`` on ``_second_order_integral_single``).
Three frequency grids: a regular one, one with exact y == 0 and x == 0
hits (y = omega + Omega_mn, x = Omega_ij - omega), and the near-singular
grid of the JAX test (omega = -Omega_01 + 1e-9, and 1e-13), where the
JAX lattice is 5.5e-5 off and the port's lattice has its
divided-difference branch.  Bounds are relative to the largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import filter_functions_tpu_torch as fft
from filter_functions_tpu import numeric as jnumeric
from filter_functions_tpu.cplx import asc
from filter_functions_tpu_torch import functional, numeric
from testutil import make_pulse, rand_pulse_arrays
from torch_testutil import fft_cpu

GRIDS = ['regular', 'hits', 'near_singular']
#: The tables against JAX's factored route and against the lattice.
PARITY = 1e-13
#: Leading batch axes and chunks: the same products in other blockings.
BLOCKING = 1e-14


def _inputs(grid):
    """(port tensors, JAX arrays) of tests/test_core.py's factored-route
    inputs, d = 3, G = 4, 2 noise operators, on *grid*: (eigvals,
    n_opers_transformed, basis_transformed, per-step and padded
    cumulative control matrices, omega, dt, weights)."""
    rng = np.random.default_rng(5)
    d, G, n_w, n_nops = 3, 4, 41, 2
    ev = rng.standard_normal((G, d))
    dt = 1 - rng.random(G)
    de = ev[0][:, None] - ev[0][None, :]
    if grid == 'regular':
        omega = np.geomspace(1e-1, 1e1, n_w)
    elif grid == 'hits':
        # omega = 0: x == 0 and y == 0 on the diagonals; +-Omega_01:
        # x == 0 at ij = 01 with y == 0 at mn = 10, and y == 0 at 01
        omega = np.concatenate([np.geomspace(1e-1, 1e1, n_w - 3),
                                [0.0, de[0, 1], -de[0, 1]]])
    else:
        omega = np.concatenate([np.geomspace(1e-1, 1e1, n_w - 2),
                                [-de[0, 1] + 1e-9, 1e-13]])

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    n_b = d * d
    n_t, b_t = cplx(n_nops, G, d, d), cplx(G, n_b, d, d)
    step, _ = (cplx(G, n_nops, n_b, n_w), cplx(G, n_nops, n_b, n_w))
    # the padded cumulative control matrices of step, which the port's
    # shifts accumulate themselves
    cum = np.concatenate([np.zeros_like(step[:1]), step.cumsum(0)[:-1]])
    w = rng.random((n_nops, n_w))
    host = (ev, n_t, b_t, step, cum, omega, dt, w)
    port = tuple(torch.as_tensor(x) for x in host)
    jax_args = tuple(asc(x) if np.iscomplexobj(x) else jnp.asarray(x)
                     for x in host)
    return port, jax_args


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _jax_factored(monkeypatch, jax_args):
    """(shifts, F^(2) total) of the JAX package's factored route."""
    monkeypatch.setenv('FF_TPU_SO_FACTORED', '1')
    try:
        return (jnumeric._second_order_diag_shifts(*jax_args),
                jnumeric._second_order_total(*jax_args[:7]))
    finally:
        monkeypatch.delenv('FF_TPU_SO_FACTORED')


def _port(args, **kw):
    """(shifts, F^(2) total) of the port, from the tables; the shifts
    take the arguments without the padded cumulative control
    matrices."""
    return (numeric._second_order_diag_shifts(*args[:4], *args[5:], **kw),
            numeric._second_order_total(*args[:7], **kw))


def _lattice(args):
    """(shifts, F^(2) total) of one pulse's step terms from the port's K2
    lattice, segment by segment as the cache path builds it; the shifts
    are sum_w weights[a, w] F^(2)[a, a, k, l, w]."""
    total = numeric._second_order_steps(*args[:7], False)[0]
    diag = torch.diagonal(total, 0, 0, 1).movedim(-1, 0)  # (a, k, l, w)
    return (diag * args[7][:, None, None, :]).sum(-1), total


@pytest.mark.parametrize('grid', GRIDS)
def test_tables_match_jax(grid):
    """The seven tables of a batch of segments against the JAX package's,
    segment by segment, within 1e-13 of each table's largest entry.

    dks_k enters the route only as dks_k yks_k with |yks_k| <=
    _SO_SMALL_Y^k, and between |u dt| = 0.2 and ~1.5 the closed form of
    both packages carries a rounding error ~eps (k+1)!/|u dt|^{k+1}
    (tests/test_torch_second_order.py::
    test_divided_difference_coefficients_match_jax), up to 3e-11 of the
    largest entry at k = 5 here; so dks is held as dks_k _SO_SMALL_Y^k,
    its largest contribution to the lattice."""
    (ev, _, _, _, _, omega, dt, _), (jev, *_, jomega, jdt, _) = \
        _inputs(grid)
    tables = numeric._second_order_factored_single(omega, ev, dt)
    G, d = ev.shape
    d2, n_w, K = d * d, len(omega), numeric._SO_SMALL_K
    shapes = [(n_w, d2), (n_w, d2), (d2, d2), (n_w, d2), (n_w, d2),
              (K, n_w, d2), (K, n_w, d2)]
    dtypes = [torch.complex128] * 3 + [torch.float64] * 2 + [
        torch.complex128, torch.float64]
    for t, shape, dtype in zip(tables, shapes, dtypes):
        assert t.shape == (G, *shape) and t.dtype == dtype
    y_max = numeric._SO_SMALL_Y ** np.arange(K)[:, None, None]
    for g in range(G):
        want = [_np(x) for x in jnumeric._second_order_factored_single(
            jomega, jev[g], jdt[g])]
        for i, (got_t, want_t) in enumerate(zip(tables, want)):
            got_t = got_t[g].numpy()
            if i == 5:
                got_t, want_t = got_t * y_max, want_t * y_max
            _close(got_t, want_t, PARITY)


@pytest.mark.parametrize('grid', GRIDS)
def test_factored_route_matches_jax_factored_route(grid, monkeypatch):
    """_second_order_diag_shifts and _second_order_total on the factored
    route against the JAX package's factored route, within 1e-13 of the
    largest entry."""
    args, jax_args = _inputs(grid)
    want_shifts, want_total = _jax_factored(monkeypatch, jax_args)
    shifts, total = _port(args)
    _close(shifts, want_shifts, PARITY)
    _close(total, want_total, PARITY)


@pytest.mark.parametrize('grid', GRIDS)
def test_factored_route_matches_lattice_route(grid):
    """The shifts and F^(2) from the tables against the port's K2
    lattice within 1e-13 of the largest entry, the near-singular grid
    included (where both take the divided-difference branch)."""
    args, _ = _inputs(grid)
    shifts, total = _port(args)
    lattice_shifts, lattice_total = _lattice(args)
    _close(shifts, lattice_shifts, PARITY)
    _close(total, lattice_total, PARITY)


def test_near_singular_grid_is_where_the_jax_lattice_misses(monkeypatch):
    """On the near-singular grid the JAX package's lattice is off both
    factored routes by far more than the bound the port's routes keep
    (5.5e-5 of the largest entry against 1e-13): the grid exercises the
    branch the JAX lattice lacks."""
    args, jax_args = _inputs('near_singular')
    want_shifts, _ = _jax_factored(monkeypatch, jax_args)
    jax_lattice = _np(jnumeric._second_order_diag_shifts(*jax_args))
    shifts, _ = _port(args)
    scale = np.abs(_np(want_shifts)).max()
    assert np.abs(jax_lattice - _np(want_shifts)).max() > 1e-8 * scale
    _close(shifts, want_shifts, PARITY)


def _batched(grid, n=3):
    """*n* jittered copies of the inputs on a leading batch axis, and the
    per-copy inputs."""
    (ev, n_t, b_t, step, cum, omega, dt, w), _ = _inputs(grid)
    scale = torch.tensor([1.0, 1.1, 0.9][:n], dtype=torch.float64)
    singles = [(ev * s, n_t, b_t, step * s, cum * s, omega, dt * s, w)
               for s in scale]
    batch = tuple(torch.stack([single[i] for single in singles])
                  for i in range(5)) + (omega,) + (
        torch.stack([single[6] for single in singles]), w)
    return batch, singles


@pytest.mark.parametrize('grid', ['regular', 'hits'])
def test_leading_batch_axes(grid):
    """A batch of three equals three single calls: the tables, the shifts
    and F^(2) on the factored route, within 1e-14 of the largest
    entry."""
    batch, singles = _batched(grid)
    tables = numeric._second_order_factored_single(batch[5], batch[0],
                                                   batch[6])
    shifts, total = _port(batch)
    for b, single in enumerate(singles):
        for got, want in zip(
                tables, numeric._second_order_factored_single(
                    single[5], single[0], single[6])):
            _close(got[b], want, BLOCKING)
        want_shifts, want_total = _port(single)
        _close(shifts[b], want_shifts, BLOCKING)
        _close(total[b], want_total, BLOCKING)


def test_chunks_match_the_unchunked_result():
    """A budget of one segment per chunk gives the unchunked shifts
    within 1e-14 and F^(2) within 1e-13, for one pulse and for a batch.

    F^(2) sums the general form's f_x r_big and f_z r_big terms over the
    segments of a chunk apart, and each is up to 1/(|y dt|) >=
    1/_SO_SMALL_Y = 100 times larger than their difference: another
    grouping of the segments moves it by up to ~2 eps/_SO_SMALL_Y
    ~ 4e-14 of its largest entry (1.9e-14 here).  The shifts reduce
    over frequencies first and keep 1e-14."""
    args, _ = _inputs('regular')
    batch, _ = _batched('regular')
    for inputs in (args, batch):
        assert numeric._factored_chunk(inputs[0], 41, 0,
                                       budget_bytes=1) == 1
        assert numeric._factored_chunk(inputs[0], 41, 0) == 4
        shifts, total = _port(inputs)
        chunked_shifts, chunked_total = _port(inputs, budget_bytes=1)
        _close(chunked_shifts, shifts, BLOCKING)
        _close(chunked_total, total, PARITY)


@pytest.mark.parametrize('batch', [(), (3,)])
def test_chunks_count_their_fixed_output(batch):
    """A step's fixed elements (F^(2)'s (n_w, A, A) per-step arrays) come
    off the budget before it is divided among segments: a budget of two
    segments above them gives chunks of two, and one below them chunks
    of one."""
    eigvals = torch.zeros(*batch, 7, 3)
    n_w, extra = 41, 5
    per_segment = n_w * (numeric._SO_FACTORED_TEMPS * 9 + extra)
    fixed = 3 * per_segment
    n = int(np.prod(batch))

    def chunk(elements):
        return numeric._factored_chunk(eigvals, n_w, extra,
                                       budget_bytes=n * elements * 16,
                                       fixed=fixed)
    assert chunk(fixed + 2 * per_segment) == 2
    assert chunk(fixed + 3 * per_segment - 1) == 2
    assert chunk(fixed) == 1
    assert numeric._factored_chunk(eigvals, n_w, extra, budget_bytes=n * (
        fixed + 2 * per_segment) * 16) == 5


def _second_order_batch(batch, n_omega):
    """bench.py's config_second_order (d = 4, 8 segments, 2 control and 2
    noise operators, GGM basis, default_rng(7)) cut to *batch* pulses
    and *n_omega* frequencies: (PulseArrays, basis, omega)."""
    d, n_dt = 4, 8
    rng = np.random.default_rng(7)

    def herm_traceless(k):
        a = rng.standard_normal((k, d, d)) + 1j * rng.standard_normal(
            (k, d, d))
        a = (a + a.conj().swapaxes(-1, -2)) / 2
        return a - (np.trace(a, axis1=-2, axis2=-1)[:, None, None]
                    * np.eye(d) / d)

    c_opers, n_opers = herm_traceless(2), herm_traceless(2)
    c_coeffs = rng.standard_normal((batch, 2, n_dt))
    dt = np.broadcast_to(1 - rng.random(n_dt), (batch, n_dt)).copy()
    basis = fft.Basis.ggm(d)
    p = functional.PulseArrays(
        *(torch.as_tensor(x) for x in (c_opers, c_coeffs, n_opers,
                                       np.ones((batch, 2, n_dt)), dt)),
        basis.tensor('cpu'))
    return p, basis, torch.as_tensor(np.geomspace(1e-1, 1e1, n_omega))


@pytest.fixture
def factored_calls(monkeypatch):
    """Counts the calls of numeric._second_order_factored_single."""
    calls = []
    original = numeric._second_order_factored_single

    def counted(*args):
        calls.append(args[1].shape)
        return original(*args)
    monkeypatch.setattr(numeric, '_second_order_factored_single', counted)
    return calls


def _object_pulse(p, basis, b):
    """Row *b* of the batch *p* as a PulseSequence on the CPU."""
    return fft.PulseSequence.from_arrays(
        p.c_opers.numpy(), ['A', 'B'], p.c_coeffs[b].numpy(),
        p.n_opers.numpy(), ['a', 'b'], p.n_coeffs[b].numpy(),
        p.dt[b].numpy(), basis=basis, device='cpu')


@pytest.mark.parametrize('kind', ['diagonal', 'cross'])
def test_batched_etm_routes_agree(kind, factored_calls):
    """functional.batched_error_transfer_matrix(second_order=True) at a
    cut config_second_order (batch 4, 32 frequencies), computed from the
    tables (frequency shifts for the diagonal spectrum 1e-4/omega, F^(2)
    for a real cross-spectrum), within 1e-13 of each row's object-path
    ETM on the K2 lattice (F^(2) cached with cache_intermediates)."""
    p, basis, omega = _second_order_batch(4, 32)
    spectrum = 1e-4 / omega
    if kind == 'cross':
        spectrum = torch.stack([torch.stack([spectrum, spectrum / 2]),
                                torch.stack([spectrum / 2, spectrum])])
    factored = functional.batched_error_transfer_matrix(
        p, spectrum, omega, basis, second_order=True)
    assert factored_calls
    factored_calls.clear()
    first = functional.batched_error_transfer_matrix(p, spectrum, omega,
                                                     basis)
    assert factored.shape == (4, 16, 16)
    for b in range(4):
        pulse = _object_pulse(p, basis, b)
        pulse.cache_filter_function(omega, order=2, cache_intermediates=True)
        lattice = fft.error_transfer_matrix(pulse, spectrum, omega,
                                            second_order=True)
        assert not factored_calls
        np.testing.assert_allclose(factored[b].numpy(), lattice.numpy(),
                                   rtol=0, atol=1e-13)
        # the second-order part is resolved: it is far above the bound
        assert (lattice - first[b]).abs().max() > 1e-9


def test_object_path_takes_the_tables(factored_calls):
    """The object path's F^(2) (``get_filter_function(order=2)``) and
    second-order ETM come from the tables unless the intermediates are
    cached, and agree with the cached lattice's within 1e-13."""
    arrays = rand_pulse_arrays(3, 4, 3, 2,
                               local_rng=np.random.default_rng(12))
    omega = np.geomspace(0.1, 10, 24)
    lattice = make_pulse(arrays, cls=fft_cpu)
    ff2 = lattice.get_filter_function(omega, order=2,
                                      cache_intermediates=True)
    etm = fft.error_transfer_matrix(lattice, 1e-3 / omega, omega,
                                    second_order=True)
    assert not factored_calls
    factored = make_pulse(arrays, cls=fft_cpu)
    _close(factored.get_filter_function(omega, order=2), ff2, PARITY)
    assert factored_calls
    factored = make_pulse(arrays, cls=fft_cpu)
    np.testing.assert_allclose(
        fft.error_transfer_matrix(factored, 1e-3 / omega, omega,
                                  second_order=True).numpy(),
        etm.numpy(), rtol=0, atol=1e-13)


def test_caching_computes_the_lattice(factored_calls):
    """With cache_intermediates the from-scratch F^(2) caches the K2
    lattice and builds no table; without it the tables give the same
    F^(2) within 1e-13."""
    arrays = rand_pulse_arrays(3, 4, 3, 2,
                               local_rng=np.random.default_rng(13))
    p = make_pulse(arrays, cls=fft_cpu)
    omega = torch.as_tensor(np.geomspace(0.1, 10, 24))

    def scratch(**kw):
        return numeric.calculate_second_order_filter_function_from_scratch(
            p.eigvals, p.eigvecs, p.propagators, omega, p.basis,
            p.n_opers_dev, p.n_coeffs, p.dt, **kw)
    cached, out = scratch(cache_intermediates=True)
    assert not factored_calls
    assert torch.equal(out['second_order_integral'],
                       numeric._second_order_integral_single(
                           omega, p.eigvals, torch.as_tensor(p.dt)))
    _close(scratch(), cached, PARITY)
    assert factored_calls
