"""The port's sharded entry points (filter_functions_tpu_torch.parallel.
sharding) against the JAX package's on the same numpy inputs.

The JAX package shards over the 8-virtual-device CPU mesh that conftest
sets up; the port runs one spawned process per device on a 'gloo' group
of the same (batch, omega) shape (torch_testutil.run_ranks), each rank
with the full inputs, and its DTensor results are gathered with
``full_tensor()``.  The collective lists the port records
(``sharding.collectives``) are checked here per call and pinned across
mesh sizes in test_torch_parallel_collectives.py.

Tolerances: filter function 1e-13 absolute, infidelity 1e-12 relative
(the integral is summed in another order), error transfer matrix 1e-13
absolute, GRAPE loss 1e-12 relative and its new coefficients within
1e-10 of learning_rate * max |grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import filter_functions_tpu as ff
from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu import parallel as jparallel
from filter_functions_tpu.cplx import asc
from testutil import make_pulse, rand_pulse_arrays, to_np
from torch_testutil import run_ranks
import torch_testutil

SUM_OMEGA = ('sum', 'omega')
SUM_BATCH = ('sum', 'batch')


@pytest.fixture(scope='module')
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    return jparallel.make_mesh(8)


@pytest.fixture(scope='module')
def mesh2x4():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    return jparallel.make_mesh(8, batch=2)


def _pulse(d, n_dt, seed, n_cops=3, n_nops=3):
    """A random pulse from default_rng(seed): (JAX PulseSequence, JAX
    PulseArrays, the port's arrays as a dict of numpy arrays)."""
    pulse = make_pulse(rand_pulse_arrays(d, n_dt, n_cops, n_nops,
                                         np.random.default_rng(seed)))
    jp = jfunctional.make_pulse_arrays(pulse)
    return pulse, jp, _host(jp)


def _host(jp) -> dict:
    return {name: to_np(getattr(jp, name)) for name in jp._fields}


def _batch(jp, scales):
    """JAX PulseArrays of len(scales) copies of *jp*, control coefficients
    scaled per row."""
    scales = np.asarray(scales, dtype=float)
    n = len(scales)
    return jfunctional.PulseArrays(
        jp.c_opers, jnp.asarray(scales[:, None, None] * np.asarray(jp.c_coeffs)),
        jp.n_opers, jnp.broadcast_to(jp.n_coeffs, (n,) + jp.n_coeffs.shape),
        jnp.broadcast_to(jp.dt, (n,) + jp.dt.shape), jp.basis)


def test_sharded_ff_matches_jax(mesh8, tmp_path):
    """Filter function with omega over 8 ranks (JAX test_parallel.py:73):
    within 1e-13 of the JAX package's sharded result, each rank holding
    8 of the 64 frequencies, and no collective."""
    _, jp, host = _pulse(2, 5, seed=1)
    omega = np.linspace(0.5, 10, 64)
    want = to_np(jparallel.sharded_filter_function(jp, jnp.asarray(omega),
                                                   mesh8))
    (got, reduced, local), = run_ranks(
        torch_testutil.rank_sharded_calls, 8, tmp_path,
        [((1, 8), 'sharded_filter_function', dict(p=host, omega=omega))])[0]
    np.testing.assert_allclose(got, want, atol=1e-13, rtol=0)
    assert local == [(3, 3, 8)] and reduced == []


def test_sharded_infidelity_matches_jax(mesh8, tmp_path):
    """Infidelity with the integral over 8 ranks (JAX test_parallel.py:84)
    against the JAX package's object API, within 1e-12 relative, with one
    SUM over 'omega'; frequencies and spectrum given as DTensors of
    shard_omega give the same result, plus one gather of the grid for the
    trapezoid weights."""
    pulse, jp, host = _pulse(2, 4, seed=2)
    omega = np.linspace(0.5, 10, 64)
    spectrum = 1e-2 / omega
    want = np.asarray(ff.infidelity(pulse, spectrum, omega))
    want_sharded = np.asarray(jparallel.sharded_infidelity(
        jp, jnp.asarray(spectrum), jnp.asarray(omega), mesh8))
    plain, dtensors = run_ranks(
        torch_testutil.rank_sharded_calls, 8, tmp_path,
        [((1, 8), 'sharded_infidelity',
          dict(p=host, spectrum=spectrum, omega=omega)),
         ((1, 8), 'sharded_infidelity',
          dict(p=host, spectrum=('shard', spectrum),
               omega=('shard', omega)))])[0]
    np.testing.assert_allclose(plain[0], want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(plain[0], want_sharded, rtol=1e-12, atol=0)
    assert plain[1] == [SUM_OMEGA]
    np.testing.assert_array_equal(dtensors[0], plain[0])
    assert dtensors[1] == [('gather', 'omega'), SUM_OMEGA]


@pytest.mark.parametrize('shape, second_order', [((2, 4), True),
                                                 ((8, 1), False)])
def test_sharded_error_transfer_matrix_matches_jax(shape, second_order,
                                                   tmp_path):
    """Batch-split error transfer matrices (JAX test_parallel.py:96, and
    the 8 x 1 mesh of :301) within 1e-13 of the JAX package's sharded
    ones, with no collective."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    pulse, jp, _ = _pulse(2, 3, seed=3, n_cops=2, n_nops=2)
    omega = np.geomspace(0.1, 10, 16)
    spectrum = 1e-3 / omega
    jb = _batch(jp, 1.0 + 0.05 * np.arange(shape[0]))
    want = np.asarray(jparallel.sharded_error_transfer_matrix(
        jb, spectrum, omega, pulse.basis, jparallel.make_mesh(8, shape[0]),
        second_order=second_order))
    (got, reduced, local), = run_ranks(
        torch_testutil.rank_sharded_calls, 8, tmp_path,
        [(shape, 'sharded_error_transfer_matrix',
          dict(p=_host(jb), spectrum=spectrum, omega=omega, basis=2,
               second_order=second_order))])[0]
    np.testing.assert_allclose(got, want, atol=1e-13, rtol=0)
    assert local == [(1, 4, 4)] and reduced == []


def test_grape_step_matches_jax(mesh2x4, tmp_path):
    """Two sharded GRAPE steps on 2 x 4 (JAX test_parallel.py:134): the
    loss within 1e-12 relative of the JAX package's and falling, the new
    coefficients within 1e-10 of learning_rate * max |grad|; per step
    one SUM over 'omega' (gradient rows and partial loss) and one over
    'batch' (the loss)."""
    _, jp, _ = _pulse(2, 4, seed=4)
    omega = np.linspace(0.5, 10, 32)
    spectrum = 1e-1 / omega
    lr = 1e-3
    jb = _batch(jp, [1.0, 1.2])
    c, want = jb.c_coeffs, []
    for _ in range(2):
        new, loss = jparallel.grape_step(c, jb, jnp.asarray(spectrum),
                                         jnp.asarray(omega), mesh2x4,
                                         learning_rate=lr)
        want.append((np.asarray(new), float(loss),
                     np.abs(np.asarray(new) - np.asarray(c)).max()))
        c = new
    steps = run_ranks(torch_testutil.rank_grape_steps, 8, tmp_path, (2, 4),
                      _host(jb), spectrum, omega, 2, lr)[0]
    for (got_c, got_loss, reduced), (want_c, want_loss, step) in zip(steps,
                                                                    want):
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-12, atol=0)
        assert np.abs(got_c - want_c).max() <= 1e-10 * step
        assert reduced == [SUM_OMEGA, SUM_BATCH]
    assert np.isfinite(steps[0][1]) and steps[1][1] < steps[0][1]


def test_sharded_batched_infidelity_flagship_shaped(mesh2x4, tmp_path):
    """The production batched entry point at the flagship's shape (d = 16,
    GGM basis, 2 segments, batch 4, 32 frequencies) over 2 x 4 (JAX
    test_parallel.py:338): within 1e-12 relative of the JAX package's
    sharded and unsharded results, with one SUM over 'omega' and each
    rank holding 2 rows (JAX's own test holds its sharded result to its
    unsharded one)."""
    local = np.random.default_rng(12)
    d, G, batch, n_omega = 16, 2, 4, 32
    a = local.standard_normal((2, d, d)) \
        + 1j * local.standard_normal((2, d, d))
    c_opers = (a + a.conj().swapaxes(-1, -2)) / 2
    a = local.standard_normal((2, d, d)) \
        + 1j * local.standard_normal((2, d, d))
    n_opers = (a + a.conj().swapaxes(-1, -2)) / 2
    jb = jfunctional.PulseArrays(
        c_opers=asc(c_opers),
        c_coeffs=jnp.asarray(local.standard_normal((batch, 2, G))),
        n_opers=asc(n_opers),
        n_coeffs=jnp.asarray(np.ones((batch, 2, G))),
        dt=jnp.asarray(np.broadcast_to(1 - local.random(G),
                                       (batch, G)).copy()),
        basis=ff.Basis.ggm(d).dev)
    omega = np.geomspace(1e-1, 1e1, n_omega)
    spectrum = 1e-4 / omega
    want = np.asarray(jparallel.sharded_batched_infidelity(
        jb, spectrum, omega, mesh2x4))
    (got, reduced, local_shape), = run_ranks(
        torch_testutil.rank_sharded_calls, 8, tmp_path,
        [((2, 4), 'sharded_batched_infidelity',
          dict(p=_host(jb), spectrum=spectrum, omega=omega))])[0]
    assert got.shape == (batch, 2) and local_shape == [(2, 2)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert reduced == [SUM_OMEGA]


def _jax_grads(fn, jp, weights):
    """jax.grad of sum(weights * fn(jp with c_coeffs, n_coeffs, dt)) with
    respect to those three, as numpy arrays by name."""
    def loss(c, n, dt):
        return (fn(jp._replace(c_coeffs=c, n_coeffs=n, dt=dt))
                * weights).sum()
    names = ('c_coeffs', 'n_coeffs', 'dt')
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(getattr(jp, name)) for name in names))
    return {name: np.asarray(g) for name, g in zip(names, grads)}


@pytest.mark.parametrize('name, shape', [
    ('sharded_infidelity', (1, 8)),
    ('sharded_batched_infidelity', (2, 4)),
    ('sharded_batched_infidelity', (8, 1))])
def test_sharded_infidelity_gradients_match_jax(name, shape, tmp_path):
    """Autograd through the sharded infidelities: on each of 8 ranks,
    ``(result.to_local() * weights).sum().backward()`` gives the gradient
    with respect to c_coeffs, n_coeffs and dt of the rank's own rows
    (every row for one pulse), within 1e-12 of their largest entry of
    jax.grad through the JAX package's sharded and unsharded functions on
    the same numpy inputs; the rows of other 'batch' blocks get exactly
    zero.  The backward pass adds one SUM over 'omega', none on a
    one-rank 'omega'; the forward's collectives are those of a call
    without gradients."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    _, jp, _ = _pulse(2, 5, seed=9)
    omega = np.linspace(0.5, 10, 64)
    spectrum = 1e-2 / omega
    rng = np.random.default_rng(9)
    s, w = jnp.asarray(spectrum), jnp.asarray(omega)
    if name == 'sharded_infidelity':
        weights = rng.standard_normal(3)
        jmesh = jparallel.make_mesh(8)
        sharded = [lambda q: jparallel.sharded_infidelity(q, s, w, jmesh),
                   lambda q: jfunctional.infidelity(q, s, w)]
    else:
        jp = _batch(jp, 1.0 + 0.03 * np.arange(8))
        weights = rng.standard_normal((8, 3))
        jmesh = jparallel.make_mesh(8, batch=shape[0])
        sharded = [lambda q: jparallel.sharded_batched_infidelity(q, s, w,
                                                                  jmesh),
                   lambda q: jfunctional.batched_infidelity(q, s, w)]
    wants = [_jax_grads(fn, jp, weights) for fn in sharded]
    ranks = run_ranks(torch_testutil.rank_sharded_grads, 8, tmp_path,
                      [(shape, name, dict(p=_host(jp), spectrum=spectrum,
                                          omega=omega), weights,
                        ('c_coeffs', 'n_coeffs', 'dt'))])
    rows_per_rank = 8 // shape[0]
    for (_, forward, backward, grads, (b, _)), in ranks:
        expected = [] if shape[1] == 1 else [SUM_OMEGA]
        assert forward == expected and backward == expected
        for key, got in grads.items():
            if name == 'sharded_batched_infidelity':
                rows = slice(b * rows_per_rank, (b + 1) * rows_per_rank)
                rest = np.ones(len(got), bool)
                rest[rows] = False
                assert not got[rest].any(), key
            else:
                rows = slice(None)
            for want in wants:
                scale = np.abs(want[key][rows]).max()
                assert scale > 0
                assert np.abs(got[rows] - want[key][rows]).max() \
                    <= 1e-12 * scale, key
