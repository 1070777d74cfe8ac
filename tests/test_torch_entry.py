"""The port's entry points (filter_functions_tpu_torch.entry) against the
repository's ``__graft_entry__`` (the JAX package's) on the CPU: the
flagship forward step of :func:`entry` within 1e-12 relative of
``__graft_entry__.entry()`` under JAX, the dry-run problem equal to the
arrays ``__graft_entry__.dryrun_multichip`` builds, and the dry run on two
spawned gloo ranks against the JAX package's ``parallel.grape_step`` on
its virtual CPU mesh (loss 1e-12 relative, new coefficients 1e-12 of
their largest entry).  Without a card, the default device raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from filter_functions_tpu import parallel as jparallel
from filter_functions_tpu import functional as jfunctional
from filter_functions_tpu.basis import Basis as JBasis
from filter_functions_tpu.cplx import asc
from filter_functions_tpu_torch import entry
from testutil import to_np


def test_entry_matches_graft_entry():
    """fn(*args) of entry(device='cpu') (native route on the CPU) against
    __graft_entry__.entry()'s step jitted on JAX's CPU: the (18,)
    infidelities within 1e-12 relative; the arguments are the flagship's
    arrays, 1000 frequencies and S = 1e-4/omega exactly."""
    fn, (p, spectrum, omega) = entry.entry(device='cpu')
    got = fn(p, spectrum, omega)
    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == (18,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(omega.numpy(), np.asarray(jargs[2]))
    np.testing.assert_array_equal(spectrum.numpy(), np.asarray(jargs[1]))
    for name in ('c_coeffs', 'n_coeffs', 'dt'):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(jargs[0], name)))
    for name in ('c_opers', 'n_opers', 'basis'):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      to_np(getattr(jargs[0], name)))


def _graft_problem(n_devices):
    """The arrays of __graft_entry__.dryrun_multichip (its lines building
    the tiny problem), as JAX PulseArrays, omega and spectrum, with the
    mesh's batch axis."""
    batch_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    rng = np.random.default_rng(0)
    d, n_dt, n_ctrl, n_nops = 2, 3, 2, 1
    batch = batch_axis * 2
    n_omega = (n_devices // batch_axis) * 4
    x = np.array([[0, 1], [1, 0]], complex) / 2
    y = np.array([[0, -1j], [1j, 0]]) / 2
    z = np.diag([1., -1.]).astype(complex) / 2
    p = jfunctional.PulseArrays(
        c_opers=asc(np.stack([x, y])),
        c_coeffs=jnp.asarray(rng.standard_normal((batch, n_ctrl, n_dt))),
        n_opers=asc(z[None]),
        n_coeffs=jnp.asarray(np.ones((batch, n_nops, n_dt))),
        dt=jnp.asarray(np.ones((batch, n_dt))),
        basis=JBasis.ggm(d).dev,
    )
    omega = jnp.asarray(np.linspace(0.5, 10, n_omega))
    spectrum = 1e-2 / omega
    return batch_axis, p, omega, spectrum


@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_dryrun_problem_is_graft_entrys(n):
    """dryrun_problem(n) holds exactly the arrays, mesh batch axis,
    frequencies and spectrum of __graft_entry__.dryrun_multichip(n)."""
    batch_axis, arrays, omega, spectrum = entry.dryrun_problem(n)
    want_axis, jp, jomega, jspectrum = _graft_problem(n)
    assert batch_axis == want_axis
    assert set(arrays) == set(jp._fields)
    for name in jp._fields:
        np.testing.assert_array_equal(arrays[name],
                                      to_np(getattr(jp, name)))
    np.testing.assert_array_equal(omega, np.asarray(jomega))
    np.testing.assert_array_equal(spectrum, np.asarray(jspectrum))


def test_dryrun_multichip_matches_jax(capsys):
    """dryrun_multichip(2, device='cpu') runs two spawned ranks over gloo
    on a 2 x 1 mesh, prints JAX's line and returns the ranks' results;
    each rank's GRAPE loss is within 1e-12 relative of the JAX package's
    grape_step on the same problem and mesh shape, its block of the new
    coefficients within 1e-12 of their largest entry, its infidelities
    within 1e-12 relative of the JAX package's
    sharded_batched_infidelity, and it launched no kernel (the CPU)."""
    if len(jax.devices()) < 2:
        pytest.skip('needs 2 devices')
    ranks = entry.dryrun_multichip(2, device='cpu')
    assert capsys.readouterr().out == (
        'dryrun: sharded GRAPE step + batched_infidelity over (2, 1) '
        '(batch, omega) mesh ok\n')
    batch_axis, jp, omega, spectrum = _graft_problem(2)
    mesh = jparallel.make_mesh(2, batch=batch_axis)
    new, loss = jparallel.grape_step(jp.c_coeffs, jp, spectrum, omega, mesh,
                                     learning_rate=1e-3)
    new = np.asarray(new)
    infid = np.asarray(jparallel.sharded_batched_infidelity(jp, spectrum,
                                                            omega, mesh))
    assert [r['coordinate'] for r in ranks] == [(0, 0), (1, 0)]
    for b, rank in enumerate(ranks):
        rows = slice(2 * b, 2 * b + 2)
        assert rank['mesh'] == (2, 1) and rank['launches'] == 0
        np.testing.assert_allclose(rank['loss'], float(loss), rtol=1e-12,
                                   atol=0)
        assert np.abs(rank['c_coeffs'] - new[rows]).max() \
            <= 1e-12 * np.abs(new).max()
        np.testing.assert_allclose(rank['infidelity'], infid[rows],
                                   rtol=1e-12, atol=0)


def test_entry_without_a_card_raises():
    """entry() and dryrun_multichip(n) default to the card and raise
    without one, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)
