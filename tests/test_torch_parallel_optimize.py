"""GRAPE of the port (filter_functions_tpu_torch.parallel: make_grape_step
and optimize_pulse) against the JAX package's on the same numpy inputs.

The port's optimizer is torch.optim.Adam, the JAX package's optax.adam:
the same update in another order of floating-point operations, so the
histories and the optimized coefficients agree within 1e-9 relative
(of their largest entry) over 20-25 steps; a GRAPE step's loss within
1e-12 relative and its coefficients within 1e-10 of learning_rate *
max |grad|.  Sharded runs use spawned 'gloo' ranks of the JAX mesh's
shape (torch_testutil.run_ranks); the pulses are random and
non-degenerate, where jax.grad and the port's autograd agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu import parallel as jparallel
from filter_functions_tpu_torch import parallel
from testutil import make_pulse, rand_pulse_arrays, to_np
from torch_testutil import pulse_arrays, run_ranks
import torch_testutil

SUM_OMEGA = ('sum', 'omega')
SUM_BATCH = ('sum', 'batch')
GATHER_BATCH = ('gather', 'batch')
HISTORY_PARITY = 1e-9


@pytest.fixture(scope='module')
def mesh2x4():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    return jparallel.make_mesh(8, batch=2)


def _case(n_dt, seed, n_omega=16):
    """(JAX PulseArrays, the port's numpy arrays, spectrum, omega) of a
    random d = 2 pulse from default_rng(seed)."""
    pulse = make_pulse(rand_pulse_arrays(2, n_dt,
                                         local_rng=np.random.default_rng(seed)))
    jp = jfunctional.make_pulse_arrays(pulse)
    omega = np.linspace(0.5, 10, n_omega)
    return jp, _host(jp), 1e-2 / omega, omega


def _host(jp) -> dict:
    return {name: to_np(getattr(jp, name)) for name in jp._fields}


def _t(x):
    return torch.tensor(np.asarray(x))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _assert_matches(got, want):
    """An optimization result (c_coeffs, infidelity, history) against the
    JAX package's."""
    for name, g, w in zip(('c_coeffs', 'infidelity', 'history'), got, want):
        assert _rel(g, w) <= HISTORY_PARITY, (name, _rel(g, w))


def _jax_result(res):
    return tuple(np.asarray(x) for x in res)


def _port_result(res):
    return tuple(x.numpy() for x in res)


def test_optimize_pulse_matches_jax():
    """Adam over 25 steps on one pulse (JAX test_parallel.py:156): the
    history, the final coefficients and infidelity within 1e-9 relative
    of the JAX package's; the loss falls."""
    jp, host, spectrum, omega = _case(4, seed=11)
    want = _jax_result(jparallel.optimize_pulse(
        jp, jnp.asarray(spectrum), jnp.asarray(omega), n_steps=25,
        learning_rate=5e-2))
    got = _port_result(parallel.optimize_pulse(
        pulse_arrays(host), _t(spectrum), _t(omega), n_steps=25,
        learning_rate=5e-2))
    assert got[2].shape == (25,) and got[1].shape == ()
    _assert_matches(got, want)
    assert got[2][-1] < got[2][0] and np.all(np.isfinite(got[0]))


def test_optimize_pulse_regularized_matches_jax():
    """A heavy power penalty (JAX test_parallel.py:192): the history
    includes it, the result matches the JAX package's, and the controls
    shrink."""
    jp, host, spectrum, omega = _case(3, seed=12)
    want = _jax_result(jparallel.optimize_pulse(
        jp, jnp.asarray(spectrum), jnp.asarray(omega), n_steps=25,
        learning_rate=5e-2, regularizer=lambda c: 1e3 * jnp.sum(c**2)))
    got = _port_result(parallel.optimize_pulse(
        pulse_arrays(host), _t(spectrum), _t(omega), n_steps=25,
        learning_rate=5e-2,
        regularizer=torch_testutil.REGULARIZERS['power']))
    _assert_matches(got, want)
    assert (got[0]**2).sum() < (host['c_coeffs']**2).sum()
    assert got[2][0] > 1e3 * (host['c_coeffs']**2).sum()


def test_optimize_pulse_batched_coeffs_only_matches_jax():
    """Only c_coeffs carries the batch axis (JAX test_parallel.py:249):
    n_coeffs and dt are broadcast, the result keeps the batch axis and
    matches the JAX package's."""
    jp, host, spectrum, omega = _case(3, seed=13)
    scales = np.linspace(0.9, 1.1, 3)[:, None, None]
    jb = jp._replace(c_coeffs=jnp.asarray(np.asarray(jp.c_coeffs)[None]
                                          * scales))
    want = _jax_result(jparallel.optimize_pulse(
        jb, jnp.asarray(spectrum), jnp.asarray(omega), n_steps=10,
        learning_rate=5e-2))
    got = _port_result(parallel.optimize_pulse(
        pulse_arrays({**host, 'c_coeffs': host['c_coeffs'][None] * scales}),
        _t(spectrum), _t(omega), n_steps=10, learning_rate=5e-2))
    assert got[0].shape == (3,) + host['c_coeffs'].shape
    assert got[1].shape == (3,)
    _assert_matches(got, want)
    assert got[2][-1] < got[2][0]


def test_make_grape_step_matches_jax():
    """The unsharded GRAPE step on plain tensors: loss within 1e-12
    relative of the JAX package's, new coefficients within 1e-10 of
    learning_rate * max |grad|; the step function is cached per
    configuration."""
    jp, host, spectrum, omega = _case(4, seed=14, n_omega=32)
    lr = 1e-3
    scales = np.array([1.0, 1.2])[:, None, None]
    n = len(scales)
    jb = jfunctional.PulseArrays(
        jp.c_opers, jnp.asarray(np.asarray(jp.c_coeffs)[None] * scales),
        jp.n_opers, jnp.broadcast_to(jp.n_coeffs, (n,) + jp.n_coeffs.shape),
        jnp.broadcast_to(jp.dt, (n,) + jp.dt.shape), jp.basis)
    want_c, want_loss = jparallel.make_grape_step(lr)(
        jb.c_coeffs, jb, jnp.asarray(spectrum), jnp.asarray(omega))
    step = parallel.make_grape_step(lr)
    assert parallel.make_grape_step(lr) is step
    pb = pulse_arrays(_host(jb))
    got_c, got_loss = step(pb.c_coeffs, pb, _t(spectrum), _t(omega))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-12,
                               atol=0)
    moved = np.abs(np.asarray(want_c) - np.asarray(jb.c_coeffs)).max()
    assert np.abs(got_c.numpy() - np.asarray(want_c)).max() <= 1e-10 * moved
    assert not got_c.requires_grad and got_c.shape == pb.c_coeffs.shape


def test_optimize_pulse_batched_sharded_matches_jax(mesh2x4, tmp_path):
    """Four candidates over 2 x 4 (JAX test_parallel.py:170): the result
    keeps the batch axis, every value within 1e-9 relative of the JAX
    package's sharded run, one SUM over 'omega' per step, and at the end
    one over 'omega' (final infidelity) and one over 'batch' (history)."""
    jp, host, spectrum, omega = _case(3, seed=15)
    batch = 4
    c0 = np.asarray(jp.c_coeffs)[None] * (
        1 + 0.1 * np.random.default_rng(3).standard_normal((batch, 1, 1)))
    jb = jfunctional.PulseArrays(
        jp.c_opers, jnp.asarray(c0), jp.n_opers,
        jnp.broadcast_to(jp.n_coeffs, (batch,) + jp.n_coeffs.shape),
        jnp.broadcast_to(jp.dt, (batch,) + jp.dt.shape), jp.basis)
    want = _jax_result(jparallel.optimize_pulse(
        jb, jnp.asarray(spectrum), jnp.asarray(omega), n_steps=20,
        learning_rate=5e-2, mesh=mesh2x4))
    (*got, reduced), = run_ranks(
        torch_testutil.rank_optimize, 8, tmp_path,
        [((2, 4), _host(jb), spectrum, omega,
          dict(n_steps=20, learning_rate=5e-2), None)])[0]
    assert got[0].shape == c0.shape and got[1].shape == (batch,)
    _assert_matches(got, want)
    assert got[2][-1] < got[2][0]
    assert reduced == [SUM_OMEGA] * 20 + [SUM_OMEGA, SUM_BATCH]


def test_regularizer_counted_once_on_a_mesh(tmp_path):
    """On 2 x 4, a regularizer enters the loss and the gradient once,
    not once per rank: a slew penalty that couples the candidates of a
    batch split over 'batch' (gathered once per step), and a power
    penalty of one pulse replicated over 'batch' (no gather, and the
    history not summed over the replicas); both within 1e-9 relative of
    the JAX package's unsharded runs."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    jp, host, spectrum, omega = _case(3, seed=16)
    batch, n_steps = 4, 8
    c0 = np.asarray(jp.c_coeffs)[None] * np.linspace(0.8, 1.2, batch)[
        :, None, None]
    jb = jp._replace(c_coeffs=jnp.asarray(c0))

    def slew(c):
        return 1e2 * jnp.sum((c[1:] - c[:-1])**2) + jnp.sum(c**2)

    want = [_jax_result(jparallel.optimize_pulse(
                jb, jnp.asarray(spectrum), jnp.asarray(omega),
                n_steps=n_steps, learning_rate=5e-2, regularizer=slew)),
            _jax_result(jparallel.optimize_pulse(
                jp, jnp.asarray(spectrum), jnp.asarray(omega),
                n_steps=n_steps, learning_rate=5e-2,
                regularizer=lambda c: 1e3 * jnp.sum(c**2)))]
    kwargs = dict(n_steps=n_steps, learning_rate=5e-2)
    out = run_ranks(torch_testutil.rank_optimize, 8, tmp_path, [
        ((2, 4), {**host, 'c_coeffs': c0}, spectrum, omega, kwargs, 'slew'),
        ((2, 4), host, spectrum, omega, kwargs, 'power')])[0]
    for (*got, _), expected in zip(out, want):
        _assert_matches(got, expected)
    assert out[0][3] == [GATHER_BATCH, SUM_OMEGA] * n_steps + [SUM_OMEGA,
                                                               SUM_BATCH]
    assert out[1][3] == [SUM_OMEGA] * (n_steps + 1)
