"""Test helpers of the PyTorch port.

testutil's pulse factories build a pulse without a device argument, and
the port's default device is the card.  :data:`fft_cpu` is the ``cls``
they take to build the port's pulse on the CPU.

:func:`run_ranks` runs a function of this module on every rank of a
``gloo`` process group of spawned processes (the port's
``parallel.ranks.run_ranks``), for the tests of
``filter_functions_tpu_torch.parallel``.  This module imports no JAX, and
each rank checks that it never does.

:func:`products_inputs` makes random arguments of the Ozaki route's slice
products (``ops.ozaki._outer_contract``), for the tests and for
``chip_smoke.py``'s phase 3b.  :func:`record_lattice_rows` records the
weighted K2 lattices that the frequency shifts build, and
:func:`k2_cell_inputs` makes the arguments of one chunk of them at the
4-qubit QFT cell's shapes, for the K2 tables kernel's tests and
``chip_smoke.py``'s phase 3c.
"""
import contextlib
import functools
import sys
import types
from pathlib import Path

import numpy as np
import torch

import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch.parallel import ranks

#: The JAX package's precomputed flagship arrays.  The port reads no
#: file; the tests hold its live QFT pulse against these.
QFT_NPZ = (Path(__file__).resolve().parents[1] / 'filter_functions_tpu'
           / 'models' / 'qft4_arrays.npz')

#: The port's Basis, and its PulseSequence bound to ``device='cpu'``.
fft_cpu = types.SimpleNamespace(
    Basis=fft.Basis,
    PulseSequence=functools.partial(fft.PulseSequence, device='cpu'))

#: Seconds a world of ranks may take, start-up included, before
#: :func:`run_ranks` kills it: a collective that some rank never joins
#: would otherwise hang the test run.  The group's own operations time
#: out after half of it.
RANK_DEADLINE = 120.0


def run_ranks(fn, world_size: int, tmp_path, *args, init: bool = True,
              deadline: float = RANK_DEADLINE) -> list:
    """``fn(*args)`` on each of *world_size* spawned ranks of a 'gloo'
    group whose files go to *tmp_path*; returns their return values in
    rank order (``parallel.ranks.run_ranks``; *init* False: no group).
    *fn* is a function of this module, and no rank may import JAX or the
    JAX package."""
    return ranks.run_ranks(_without_jax, world_size, fn.__name__, *args,
                           init=init, deadline=deadline,
                           workdir=str(tmp_path))


@contextlib.contextmanager
def one_thread():
    """Run the block on one thread, as the ranks of :func:`run_ranks` run:
    a reduction then sums in the ranks' order, bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _without_jax(name, *args):
    """The function *name* of this module on *args*, in a rank that has
    imported neither JAX nor the JAX package."""
    result = globals()[name](*args)
    for module in ('jax', 'filter_functions_tpu'):
        if module in sys.modules:
            raise RuntimeError(f'a rank imported {module}')
    return result


# -----------------------------------------------------------------------------
# Rank functions: the port's side of the tests of parallel/.  Inputs and
# results are numpy arrays; every rank gathers a DTensor with
# .full_tensor(), a collective, before it returns.
# -----------------------------------------------------------------------------
def pulse_arrays(arrays: dict) -> 'fft.functional.PulseArrays':
    """The port's PulseArrays on the CPU from a dict of numpy arrays."""
    return fft.convert.pulse_arrays_from_numpy(arrays, device='cpu')


def products_inputs(batch, M, K, N, slice_bits, device, seed,
                    p_dtype=torch.float32):
    """Random digit slices and power-of-two scales of a call of
    ``ozaki._outer_contract``: (pr, pi, ps, outs), the row scales in
    *p_dtype* (P's), the D slices K-contiguous (batch, K, N) views of one
    (batch, 3, n, N, K) digit tensor, as the route makes them."""
    n = -(-30 // slice_bits)
    g = torch.Generator(device=device).manual_seed(seed)
    lim = 2**(slice_bits - 1)

    def digits(*shape):
        return torch.randint(-lim, lim + 1, shape, generator=g,
                             device=device, dtype=torch.int8)

    def pow2(lo, hi, shape, dtype):
        return torch.exp2(torch.randint(lo, hi, shape, generator=g,
                                        device=device).to(dtype))

    sides = [([digits(batch, M, K) for _ in range(n)],
              pow2(-20, 5, (batch, M, 1), p_dtype)) for _ in range(3)]
    d = digits(batch, 3, n, N, K)
    outs = [([d[:, t, s].transpose(-1, -2) for s in range(n)],
             pow2(-40, -10, (batch, N), torch.float64)[..., None, :])
            for t in range(3)]
    return (*sides, outs)


#: Complex elements a segment that the shifts' sandwich holds at the
#: 4-qubit QFT pulse (18 noise operators, 256 basis elements, d^2 = 256):
#: ``numeric._second_order_diag_shifts``' *held*.
QFT4_HELD = 3 * 18 * 256 * 256


def k2_cell_inputs(n_s, device):
    """One chunk of the shifts' weighted K2 lattice at the 4-qubit QFT
    cell's shapes, (omega, eigvals, dt, weights): the eigenvalues of the
    pulse's 13 segments in a batch of 4 (control amplitudes scaled by 1,
    1.03, 0.97, 1.05), cut to the chunk of segments that the route of
    *device* takes for n_s rows, 1000 frequencies in geomspace(1e-2,
    1e2), and n_s rows of 1/omega trapezoid weights scaled from 1 to 2."""
    from filter_functions_tpu_torch import numeric
    from filter_functions_tpu_torch.models import qft
    p = qft.qft_pulse_arrays(4, device=device)
    scale = torch.tensor([1.0, 1.03, 0.97, 1.05], dtype=torch.float64,
                         device=device)[:, None, None]
    ham = torch.einsum('bkg,kij->bgij', (p.c_coeffs[None] * scale).to(
        p.c_opers.dtype), p.c_opers)
    eigvals = torch.linalg.eigvalsh(ham)
    dt = p.dt.expand(4, -1)
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, 1000)).to(device)
    weights = numeric._spectral_weights(1e-4 / omega, omega, 1) * \
        torch.linspace(1, 2, n_s, dtype=torch.float64,
                       device=device)[:, None]
    chunk = numeric._shifts_chunk(eigvals, 1000, n_s,
                                  kernel=eigvals.is_cuda, held=QFT4_HELD)
    return omega, eigvals[:, :chunk], dt[:, :chunk], weights


def record_lattice_rows(monkeypatch) -> list:
    """A list that gets the number of rows of weights of every weighted
    K2 lattice of the frequency shifts
    (``numeric._factored_weighted_lattice``) built from now on."""
    from filter_functions_tpu_torch import numeric
    built = []
    build = numeric._factored_weighted_lattice

    def recorded(omega, eigvals, dt, weights, *budget):
        built.append(weights.shape[0])
        return build(omega, eigvals, dt, weights, *budget)
    monkeypatch.setattr(numeric, '_factored_weighted_lattice', recorded)
    return built


def _np(x):
    """A DTensor's full value (a collective) or a tensor, as numpy."""
    if hasattr(x, 'full_tensor'):
        x = x.full_tensor()
    return x.detach().numpy()


def rank_sharded_calls(calls):
    """Run each of *calls*, (mesh shape, name, kwargs) with numpy
    arguments and the pulse as the dict ``p``, on a (batch, omega) mesh
    of that shape; returns [(result, collectives, local shapes)] in
    order.  Names are those of ``parallel``; ``basis`` is the dimension
    of a GGM basis, and an argument given as ('shard', array) is passed
    through ``shard_omega``."""
    from filter_functions_tpu_torch import parallel
    from filter_functions_tpu_torch.parallel import sharding
    meshes, out = {}, []
    for shape, name, kwargs in calls:
        if shape not in meshes:
            meshes[shape] = parallel.make_mesh(shape[0] * shape[1],
                                               batch=shape[0], device='cpu')
        mesh = meshes[shape]
        kwargs = dict(kwargs)
        for key, value in kwargs.items():
            if key == 'p':
                kwargs[key] = pulse_arrays(value)
            elif key == 'basis':
                kwargs[key] = fft.Basis.ggm(value)
            elif isinstance(value, tuple) and value[0] == 'shard':
                kwargs[key] = parallel.shard_omega(torch.tensor(value[1]),
                                                   mesh)
            elif isinstance(value, np.ndarray):
                kwargs[key] = torch.tensor(value)
        sharding.collectives = []
        result = getattr(parallel, name)(mesh=mesh, **kwargs)
        reduced = list(sharding.collectives)
        results = result if isinstance(result, tuple) else (result,)
        local = [tuple(r.to_local().shape) for r in results]
        full = tuple(_np(r) for r in results)
        out.append((full if isinstance(result, tuple) else full[0], reduced,
                    local))
    return out


def rank_sharded_grads(calls):
    """Backpropagate a weighted sum of each of *calls*, (mesh shape, name,
    kwargs, weights, names of the inputs that require grad) with kwargs
    as in :func:`rank_sharded_calls` (``p`` a dict of numpy arrays;
    *weights* of the whole result's shape, each rank weighing its own
    block): ``(result.to_local() * weights' block).sum().backward()``.
    Returns, per call, (the local result, the forward's collectives, the
    backward's collectives, {input name: its gradient}, this rank's mesh
    coordinate)."""
    from filter_functions_tpu_torch import parallel
    from filter_functions_tpu_torch.parallel import sharding
    meshes, out = {}, []
    for shape, name, kwargs, weights, grad_names in calls:
        if shape not in meshes:
            meshes[shape] = parallel.make_mesh(shape[0] * shape[1],
                                               batch=shape[0], device='cpu')
        mesh = meshes[shape]
        p = pulse_arrays(kwargs['p'])
        spectrum = torch.tensor(kwargs['spectrum'])
        inputs = {**p._asdict(), 'spectrum': spectrum}
        for key in grad_names:
            inputs[key].requires_grad_(True)
        sharding.collectives = []
        result = getattr(parallel, name)(
            p, spectrum, torch.tensor(kwargs['omega']), mesh)
        forward = list(sharding.collectives)
        local = result.to_local()
        weights = torch.tensor(weights)
        if name == 'sharded_batched_infidelity':
            weights = sharding._block(weights, mesh, 'batch', 0)
        sharding.collectives = []
        (local * weights).sum().backward()
        backward = list(sharding.collectives)
        out.append((local.detach().numpy(), forward, backward,
                    {key: inputs[key].grad.numpy() for key in grad_names},
                    tuple(mesh.get_coordinate())))
    return out


def rank_raises(calls):
    """For each call of *calls* as in :func:`rank_sharded_calls` (or, with
    a name None, ``make_mesh(n_devices, batch)`` for a shape (n_devices,
    batch)), the name of the exception it raises (None if it returns)."""
    from filter_functions_tpu_torch import parallel
    return [_raised(parallel.make_mesh, *call[0], 'cpu') if call[1] is None
            else _raised(rank_sharded_calls, [call])
            for call in calls]


def rank_grape_steps(shape, p, spectrum, omega, n_steps, learning_rate):
    """*n_steps* chained grape_step calls on a mesh of *shape*: [(new
    c_coeffs, loss, collectives)] per step."""
    from filter_functions_tpu_torch import parallel
    from filter_functions_tpu_torch.parallel import sharding
    mesh = parallel.make_mesh(shape[0] * shape[1], batch=shape[0],
                              device='cpu')
    pulses = pulse_arrays(p)
    c = pulses.c_coeffs
    spectrum, omega = torch.tensor(spectrum), torch.tensor(omega)
    out = []
    for _ in range(n_steps):
        sharding.collectives = []
        c, loss = parallel.grape_step(c, pulses, spectrum, omega, mesh,
                                      learning_rate=learning_rate)
        out.append((_np(c), _np(loss), list(sharding.collectives)))
    return out


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as exc:       # noqa: BLE001 - the test reads the name
        return type(exc).__name__
    return None


def rank_optimize(cases):
    """optimize_pulse for each (mesh shape, p, spectrum, omega, kwargs,
    regularizer) of *cases*, the regularizer named in
    :data:`REGULARIZERS` (or None): [(c_coeffs, infidelity, history,
    collectives)]."""
    from filter_functions_tpu_torch import parallel
    from filter_functions_tpu_torch.parallel import sharding
    out = []
    for shape, p, spectrum, omega, kwargs, regularizer in cases:
        mesh = parallel.make_mesh(shape[0] * shape[1], batch=shape[0],
                                  device='cpu')
        sharding.collectives = []
        res = parallel.optimize_pulse(
            pulse_arrays(p), torch.tensor(spectrum), torch.tensor(omega),
            mesh=mesh, regularizer=REGULARIZERS.get(regularizer), **kwargs)
        reduced = list(sharding.collectives)
        out.append(tuple(_np(x) for x in res) + (reduced,))
    return out


def rank_group_of_one(p, spectrum, omega, chunk_size):
    """make_mesh without a process group: the errors it raises, the group
    of one it creates, and sharded_batched_infidelity on that mesh
    against the unsharded call (torch.equal) with its collectives."""
    import torch.distributed as dist
    from filter_functions_tpu_torch import functional, parallel
    from filter_functions_tpu_torch.parallel import sharding
    errors = [_raised(parallel.make_mesh, 2, 1, 'cpu')]
    if not torch.cuda.is_available():
        errors.append(_raised(parallel.make_mesh, None, 1, 'cuda'))
    mesh = parallel.make_mesh(device='cpu')
    pulses = pulse_arrays(p)
    spectrum, omega = torch.tensor(spectrum), torch.tensor(omega)
    sharding.collectives = []
    got = parallel.sharded_batched_infidelity(pulses, spectrum, omega, mesh,
                                              chunk_size=chunk_size)
    reduced = list(sharding.collectives)
    want = functional.batched_infidelity(pulses, spectrum, omega,
                                         chunk_size=chunk_size)
    return dict(errors=errors, world=dist.get_world_size(),
                shape=tuple(mesh.shape), names=mesh.mesh_dim_names,
                equal=torch.equal(got.full_tensor(), want),
                collectives=reduced)


def _power_penalty(c):
    return 1e3 * (c**2).sum()


def _slew_penalty(c):
    """Couples neighbouring candidates of a batch, so that it does not
    separate by rows."""
    return 1e2 * ((c[1:] - c[:-1])**2).sum() + (c**2).sum()


#: Regularizers by name: a spawned rank takes them from here.
REGULARIZERS = {'power': _power_penalty, 'slew': _slew_penalty}
