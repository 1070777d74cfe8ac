"""The collectives of the port's sharded entry points (filter_functions_
tpu_torch.parallel.sharding): the lists ``sharding.collectives`` records
at n = 1, 2, 4, 8 ranks (the counterpart of the JAX tests' count of
all-reduces in the compiled HLO), the deep factored route on split
meshes, the escalation decided for the whole call, and the errors of
meshes and inputs that do not divide.

Ranks are spawned processes on a 'gloo' group (torch_testutil.run_ranks)
with the full inputs each.  Tolerances: infidelity 1e-12 relative (the
integral is summed in another order), error transfer matrix 1e-13
absolute; on the deep route the filter function's frequency rows are
held bit for bit, against references computed on one thread as each
rank computes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import filter_functions_tpu as ff
from filter_functions_tpu import functional as jfunctional
import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import functional
from testutil import make_pulse, rand_pulse_arrays, to_np
from torch_testutil import one_thread, pulse_arrays, run_ranks
import torch_testutil

SUM_OMEGA = ('sum', 'omega')
SUM_BATCH = ('sum', 'batch')
MAX_OMEGA = ('max', 'omega')
MAX_MESH = ('max', None)


def _host(jp) -> dict:
    return {name: to_np(getattr(jp, name)) for name in jp._fields}


def _batch(jp, scales):
    """JAX PulseArrays of len(scales) copies of *jp*, control coefficients
    scaled per row."""
    scales = np.asarray(scales, dtype=float)
    n = len(scales)
    return jfunctional.PulseArrays(
        jp.c_opers,
        jnp.asarray(scales[:, None, None] * np.asarray(jp.c_coeffs)),
        jp.n_opers, jnp.broadcast_to(jp.n_coeffs, (n,) + jp.n_coeffs.shape),
        jnp.broadcast_to(jp.dt, (n,) + jp.dt.shape), jp.basis)


def _pulse(d, n_dt, seed, n_cops=3, n_nops=3):
    """A random pulse from default_rng(seed): (JAX PulseArrays, the port's
    arrays as a dict of numpy arrays)."""
    pulse = make_pulse(rand_pulse_arrays(d, n_dt, n_cops, n_nops,
                                         np.random.default_rng(seed)))
    jp = jfunctional.make_pulse_arrays(pulse)
    return jp, _host(jp)


@pytest.fixture(scope='module')
def scaling_case():
    """The inputs of the scaling test and the JAX package's unsharded
    results on them (its object API, one pulse at a time): one pulse, a
    batch of 4 and one of 8 (for the ETM), 64 frequencies (16 for the
    ETM), so that every mesh of 1 to 8 ranks divides them."""
    arrays = rand_pulse_arrays(2, 4, 3, 3, np.random.default_rng(5))
    omega = np.linspace(0.5, 10, 64)
    spectrum = 1e-2 / omega
    etm_omega = np.geomspace(0.1, 10, 16)
    scales = 1.0 + 0.01 * np.arange(8)
    pulses = [make_pulse((arrays[0], arrays[1], scale * arrays[2])
                         + arrays[3:]) for scale in scales]
    want = [np.asarray(ff.infidelity(pulses[0], spectrum, omega)),
            np.stack([np.asarray(ff.infidelity(p, spectrum, omega))
                      for p in pulses[:4]]),
            np.stack([np.asarray(ff.error_transfer_matrix(
                p, 1e-3 / etm_omega, etm_omega)) for p in pulses])]
    jp = jfunctional.make_pulse_arrays(pulses[0])
    calls = [('sharded_infidelity',
              dict(p=_host(jp), spectrum=spectrum, omega=omega)),
             ('sharded_batched_infidelity',
              dict(p=_host(_batch(jp, scales[:4])), spectrum=spectrum,
                   omega=omega)),
             ('sharded_error_transfer_matrix',
              dict(p=_host(_batch(jp, scales)), spectrum=1e-3 / etm_omega,
                   omega=etm_omega, basis=2))]
    return calls, want


@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_collectives_and_parity_scaling(n, scaling_case, tmp_path):
    """Over n = 1, 2, 4, 8 ranks (JAX test_parallel.py:266): one SUM over
    'omega' for the infidelity (on a 1 x n mesh) and for the batched
    infidelity (on 1 x 2, 2 x 2, 2 x 4), none for the batch-split error
    transfer matrix (n x 1), and none at all on one rank; the results
    within 1e-12 relative (1e-13 absolute for the ETM) of the JAX
    package's unsharded ones."""
    if n > len(jax.devices()):
        pytest.skip('needs 8 virtual devices')
    calls, want = scaling_case
    batch_axis = 1 if n <= 2 else 2
    shapes = [(1, n), (batch_axis, n // batch_axis), (n, 1)]
    out = run_ranks(torch_testutil.rank_sharded_calls, n, tmp_path,
                    [(shape,) + call for shape, call in zip(shapes,
                                                            calls)])[0]
    np.testing.assert_allclose(out[0][0], want[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(out[1][0], want[1], rtol=1e-12, atol=0)
    np.testing.assert_allclose(out[2][0], want[2], atol=1e-13, rtol=0)
    expected = [] if n == 1 else [SUM_OMEGA]
    assert [reduced for _, reduced, _ in out] == [expected, expected, []]


@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_backward_collectives_scaling(n, scaling_case, tmp_path):
    """Over n = 1, 2, 4, 8 ranks, a backward pass through the sharded
    infidelities (gradients with respect to c_coeffs, n_coeffs and dt)
    adds exactly one SUM over 'omega' to the forward's collectives, which
    stay as pinned above: on the 1 x n mesh of sharded_infidelity and on
    the meshes of sharded_batched_infidelity of the scaling test; none on
    an n x 1 mesh (the 8-row batch split over 'batch') or on one rank,
    and none when only the spectrum requires grad.  Each rank's
    infidelities are those of the call without gradients (1e-12
    relative to the JAX package's)."""
    if n > len(jax.devices()):
        pytest.skip('needs 8 virtual devices')
    calls, want = scaling_case
    batch_axis = 1 if n <= 2 else 2
    pulse = ('c_coeffs', 'n_coeffs', 'dt')
    infid, batched, etm = (kwargs for _, kwargs in calls)
    eight = dict(p=etm['p'], spectrum=infid['spectrum'],
                 omega=infid['omega'])
    rng = np.random.default_rng(n)
    cases = [((1, n), 'sharded_infidelity', infid, rng.standard_normal(3),
              pulse),
             ((batch_axis, n // batch_axis), 'sharded_batched_infidelity',
              batched, rng.standard_normal((4, 3)), pulse),
             ((n, 1), 'sharded_batched_infidelity', eight,
              rng.standard_normal((8, 3)), pulse),
             ((1, n), 'sharded_infidelity', infid, rng.standard_normal(3),
              ('spectrum',))]
    out = run_ranks(torch_testutil.rank_sharded_grads, n, tmp_path,
                    cases)[0]
    split = [] if n == 1 else [SUM_OMEGA]
    assert [forward for _, forward, _, _, _ in out] == [split, split, [],
                                                         split]
    assert [backward for _, _, backward, _, _ in out] == [split, split, [],
                                                          []]
    (got_infid, *_), (got_batched, *_) = out[:2]
    np.testing.assert_allclose(got_infid, want[0], rtol=1e-12, atol=0)
    b = out[1][4][0]
    rows = 4 // batch_axis
    np.testing.assert_allclose(got_batched, want[1][b * rows:(b + 1) * rows],
                               rtol=1e-12, atol=0)


def test_backward_packs_complex_gradients(tmp_path):
    """Gradients with respect to the complex operators travel through the
    backward pass's one float64 buffer beside the real ones: on a 1 x 2
    mesh, each rank's gradients of a weighted sharded_infidelity with
    respect to c_opers, c_coeffs (an odd number of entries before
    n_opers in the buffer), n_opers and dt are within 1e-12 (of their
    largest entry) of the unsharded functional.infidelity's, with one
    SUM over 'omega'."""
    jp, host = _pulse(2, 5, seed=10)
    host['c_coeffs'] = host['c_coeffs'][:, :3]
    host['n_coeffs'] = host['n_coeffs'][:, :3]
    host['dt'] = host['dt'][:3]
    omega = np.linspace(0.5, 10, 16)
    spectrum = 1e-2 / omega
    weights = np.random.default_rng(10).standard_normal(3)
    names = ('c_opers', 'c_coeffs', 'n_opers', 'dt')
    p = pulse_arrays(host)
    for name in names:
        getattr(p, name).requires_grad_(True)
    loss = (functional.infidelity(p, torch.tensor(spectrum),
                                  torch.tensor(omega))
            * torch.tensor(weights)).sum()
    want = dict(zip(names, torch.autograd.grad(
        loss, [getattr(p, name) for name in names])))
    out = run_ranks(torch_testutil.rank_sharded_grads, 2, tmp_path,
                    [((1, 2), 'sharded_infidelity',
                      dict(p=host, spectrum=spectrum, omega=omega), weights,
                      names)])
    for (_, forward, backward, grads, _), in out:
        assert forward == backward == [SUM_OMEGA]
        for name in names:
            w = want[name].numpy()
            assert grads[name].dtype == w.dtype
            assert np.abs(grads[name] - w).max() <= 1e-12 * np.abs(w).max()


@pytest.fixture(scope='module')
def deep_case():
    """A random d = 16 pulse of 5 segments (K = 1280: the deep factored
    route), 2 rows, 16 frequencies, as a dict of numpy arrays, with the
    unsharded port's results on the 'ozaki' route (plain digits on the
    CPU) and the quantization ratios of each row on each half of the
    grid.  The unsharded results come from one thread, as each rank
    computes, so that they compare bit for bit."""
    arrays = rand_pulse_arrays(16, 5, 2, 2, np.random.default_rng(6))
    c_opers, _, c_coeffs, n_opers, _, n_coeffs, dt = arrays
    host = dict(c_opers=c_opers, c_coeffs=np.stack([c_coeffs,
                                                    1.1 * c_coeffs]),
                n_opers=n_opers, n_coeffs=np.stack([n_coeffs] * 2),
                dt=np.stack([dt] * 2), basis=fft.Basis.ggm(16).np)
    omega = np.geomspace(1e-1, 1e1, 16)
    spectrum = 1e-4 / omega
    p, s, w = pulse_arrays(host), torch.tensor(spectrum), torch.tensor(omega)
    one = pulse_arrays(_row(host))
    lr = 1e-3
    from filter_functions_tpu_torch import parallel
    with one_thread():
        halves = [functional._batched_stat(p, s[sl], w[sl], None, 'stat',
                                           'ozaki')[1].numpy()
                  for sl in (slice(0, 8), slice(8, 16))]
        rows = functional._batched_stat(p, s, w, None, 'stat', 'ozaki')
        want = dict(
            ff=functional.fidelity_filter_function(one, w, 'ozaki').numpy(),
            infid=functional.infidelity(one, s, w, 'ozaki').numpy(),
            batch=functional.batched_infidelity(p, s, w,
                                                contract='ozaki').numpy(),
            grape=parallel.make_grape_step(lr, contract='ozaki')(
                p.c_coeffs, p, s, w),
            rows=(rows[0].numpy(), rows[1].numpy()), lr=lr)
    return host, spectrum, omega, np.stack(halves), want


def _row(host, b=0):
    return {**host, 'c_coeffs': host['c_coeffs'][b],
            'n_coeffs': host['n_coeffs'][b], 'dt': host['dt'][b]}


def test_ozaki_route_on_split_meshes(deep_case, tmp_path):
    """On the deep factored route (plain digits on the CPU), a 1 x 2 and a
    2 x 1 mesh reproduce the unsharded port: the filter function's
    frequency rows exactly (one power-of-two scale per row), the
    infidelities within 1e-12 relative, a GRAPE step's loss within 1e-12
    and its coefficients within 1e-10 of learning_rate * max |grad|.
    The escalation decision adds one MAX: over 'omega' for one pulse,
    over the whole mesh for a batch."""
    host, spectrum, omega, halves, want = deep_case
    assert halves.max() < 0.1          # no escalation at the default
    ff_want, infid_want, batch_want = want['ff'], want['infid'], want['batch']
    lr = want['lr']
    c_want, loss_want = (x.numpy() for x in want['grape'])
    step = np.abs(c_want - host['c_coeffs']).max()
    calls = []
    for shape in ((1, 2), (2, 1)):
        calls += [(shape, 'sharded_filter_function',
                   dict(p=_row(host), omega=omega, contract='ozaki')),
                  (shape, 'sharded_infidelity',
                   dict(p=_row(host), spectrum=spectrum, omega=omega,
                        contract='ozaki')),
                  (shape, 'sharded_batched_infidelity',
                   dict(p=host, spectrum=spectrum, omega=omega,
                        contract='ozaki', chunk_size=1)),
                  (shape, 'grape_step',
                   dict(c_coeffs=host['c_coeffs'], p=host,
                        spectrum=spectrum, omega=omega, learning_rate=lr,
                        contract='ozaki'))]
    out = run_ranks(torch_testutil.rank_sharded_calls, 2, tmp_path,
                    calls)[0]
    for i, omega_split in ((0, True), (4, False)):
        (ff_got, ff_reduced, _), (infid, infid_reduced, _), \
            (batch, batch_reduced, _), ((c, loss), grape_reduced, _) = \
            out[i:i + 4]
        np.testing.assert_array_equal(ff_got, ff_want)
        np.testing.assert_allclose(infid, infid_want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(batch, batch_want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(loss, loss_want, rtol=1e-12, atol=0)
        assert np.abs(c - c_want).max() <= 1e-10 * step
        if omega_split:
            assert ff_reduced == [MAX_OMEGA]
            assert infid_reduced == [MAX_OMEGA, SUM_OMEGA]
            assert batch_reduced == [MAX_MESH, SUM_OMEGA]
            assert grape_reduced == [MAX_MESH, SUM_OMEGA]
        else:
            assert ff_reduced == infid_reduced == []
            assert batch_reduced == [MAX_MESH]
            assert grape_reduced == [MAX_MESH, SUM_BATCH]


def test_escalation_is_decided_for_the_whole_call(deep_case, tmp_path):
    """With the threshold between the quantization ratios of two ranks'
    shares, the unsharded call reruns everything on the full-precision
    route, and so does every rank of the sharded call: on a 2 x 1 mesh
    the row whose own ratio stays below the threshold comes out as the
    unsharded call's (exactly, not as its fast pass), on a 1 x 2 mesh
    the frequency half whose ratio stays below it too."""
    host, spectrum, omega, halves, want = deep_case
    p, s, w = pulse_arrays(host), torch.tensor(spectrum), torch.tensor(omega)
    (fast, by_row), by_half = want['rows'], halves.max(1)
    row_tol, half_tol = by_row.mean(), by_half.mean()
    low_row, low_half = by_row.argmin(), by_half.argmin()
    assert by_row.min() < row_tol < by_row.max()
    assert by_half.min() < half_tol < by_half.max()
    one = pulse_arrays(_row(host))
    with one_thread():
        batch_want = functional.batched_infidelity(
            p, s, w, contract='ozaki', escalation_tol=row_tol).numpy()
        ff_want = functional.fidelity_filter_function(
            one, w, 'ozaki', escalation_tol=half_tol).numpy()
    out = run_ranks(torch_testutil.rank_sharded_calls, 2, tmp_path, [
        ((2, 1), 'sharded_batched_infidelity',
         dict(p=host, spectrum=spectrum, omega=omega, contract='ozaki',
              escalation_tol=row_tol)),
        ((1, 2), 'sharded_filter_function',
         dict(p=_row(host), omega=omega, contract='ozaki',
              escalation_tol=half_tol))])[0]
    (batch, batch_reduced, _), (ff_got, ff_reduced, _) = out
    np.testing.assert_array_equal(batch, batch_want)
    assert not np.array_equal(batch[low_row], fast[low_row])
    np.testing.assert_array_equal(ff_got, ff_want)
    half = slice(8 * low_half, 8 * low_half + 8)
    assert not np.array_equal(ff_got[..., half], want['ff'][..., half])
    assert batch_reduced == [MAX_MESH] and ff_reduced == [MAX_OMEGA]


def test_non_dividing_axes_raise(tmp_path):
    """A frequency grid or batch that its mesh dimension does not divide
    raises ValueError, as the JAX package's device_put does; so do a
    batch axis that does not divide the ranks and a device count other
    than the world size."""
    jp, host = _pulse(2, 3, seed=7)
    omega = np.linspace(0.5, 10, 7)
    jb = _host(_batch(jp, [1.0, 1.1, 1.2]))
    got = run_ranks(torch_testutil.rank_raises, 2, tmp_path, [
        ((1, 2), 'sharded_filter_function', dict(p=host, omega=omega)),
        ((1, 2), 'sharded_infidelity',
         dict(p=host, spectrum=1 / omega, omega=omega)),
        ((2, 1), 'sharded_batched_infidelity',
         dict(p=jb, spectrum=1 / omega[:6], omega=omega[:6])),
        ((2, 1), 'sharded_error_transfer_matrix',
         dict(p=jb, spectrum=1 / omega, omega=omega, basis=2)),
        ((2, 1), 'grape_step',
         dict(c_coeffs=jb['c_coeffs'], p=jb, spectrum=1 / omega[:6],
              omega=omega[:6])),
        ((2, 3), None, {}), ((4, 1), None, {}),
        ((1, 2), 'sharded_infidelity',
         dict(p=host, spectrum=1 / omega[:6], omega=omega[:6]))])[0]
    assert got == ['ValueError'] * 7 + [None]


def test_make_mesh_creates_a_group_of_one(tmp_path):
    """Without a process group, make_mesh() creates a group of one and a
    1 x 1 mesh on which sharded_batched_infidelity is the unsharded call
    bit for bit with no collective; a larger mesh without a group and a
    CUDA mesh without a card raise."""
    jp, _ = _pulse(2, 4, seed=8)
    omega = np.linspace(0.5, 10, 16)
    got, = run_ranks(torch_testutil.rank_group_of_one, 1, tmp_path,
                     _host(_batch(jp, [1.0, 1.1, 1.2, 1.3])), 1e-2 / omega,
                     omega, 2, init=False)
    assert got['errors'] == ['RuntimeError'] * len(got['errors'])
    assert got['world'] == 1 and got['shape'] == (1, 1)
    assert got['names'] == ('batch', 'omega')
    assert got['equal'] and got['collectives'] == []
