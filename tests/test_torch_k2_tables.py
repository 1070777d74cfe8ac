"""The weighted K2 lattice of the second-order frequency shifts on the
tables kernel's route (filter_functions_tpu_torch.ops.k2_tables) against
the plain version (``numeric._factored_weighted_lattice_plain``).

On the CPU: the route's autograd Function gives the plain version's value
and its derivatives in the eigenvalues, the durations and the weights;
the chunk count of the kernel's route; the wrapper's checks.  On the
card (``gpu``): the kernel route against the plain version on the card,
at the 4-qubit QFT cell's shapes and at eigenvalues placed on every
branch of the tables, and one launch a chunk of the shifts.

Tolerance on the card: 1e-13 of max|ell|.  The kernel builds every
table entry with the plain version's arithmetic, operation for
operation, but the reduction over (term, frequency) runs as one DGEMM
of K = 8 n_w against the plain version's two products of other shapes,
so the order of the sums differs (a few eps of max|ell| at K = 8000),
and so does that of the two-stage polynomials of D_k, whose closed form
cancels as eps (k+1)!/|u dt|^(k+1) near |u dt| = 0.2 in both versions;
D_k enters ell only through (y dt)^k < 1e-2^k.
"""
import math

import numpy as np
import pytest
import torch

from filter_functions_tpu_torch import functional, numeric, tracing
from filter_functions_tpu_torch.basis import Basis
from filter_functions_tpu_torch.ops import k2_tables
from torch_testutil import QFT4_HELD, k2_cell_inputs

CARD_TOL = 1e-13


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def branch_inputs(batch, n_s, device='cpu', n_w=37):
    """Eigenvalues that put the tables on every branch, at d = 3 over two
    segments (with a leading *batch* axis unless None): omega = 1.5 is
    both x == 0 (Omega_10 = 1.5) and y == 0 (Omega_01 = -1.5), 1.5 + 1e-5
    grazes (0 < |y dt| < 1e-2), and the sweep crosses |x dt| = 0.2 on both
    sides.  Returns (omega, eigvals, dt, weights (n_s, n_w))."""
    rng = np.random.default_rng(41)
    ev = np.array([[0.0, 1.5, 4.0], [-0.7, 0.2, 3.1]])
    dt = np.array([0.8, 1.3])
    if batch is not None:
        scale = 1 + 0.1 * np.arange(batch)[:, None, None]
        ev = ev[None] * scale
        ev[:, 0] = [0.0, 1.5, 4.0]             # every row on the branches
        dt = np.broadcast_to(dt, (batch, 2)).copy()
    omega = np.sort(np.concatenate([[1.5, 1.5 + 1e-5, 2.5, 4.0 - 3e-4],
                                    np.geomspace(0.01, 20, n_w - 4)]))
    return (_t(omega).to(device), _t(ev).to(device), _t(dt).to(device),
            _t(rng.random((n_s, n_w))).to(device))


def _branches_hit(omega, eigvals, dt):
    x, y, _, a, b, *_ = numeric._k2_arguments(omega, eigvals, dt)
    ydt = y * dt[..., None, None]
    w = a[..., :, None] + b[..., None, :]
    return {'y == 0': bool((y == 0).any()), 'x == 0': bool((x == 0).any()),
            'grazing': bool(((y != 0) & (ydt.abs() < 1e-2)).any()),
            'series': bool((w.abs() <= 0.2).any()),
            'closed form': bool((w.abs() > 0.2).any())}


def test_branch_inputs_hit_every_branch():
    omega, eigvals, dt, _ = branch_inputs(2, 1)
    assert all(_branches_hit(omega, eigvals, dt).values())


# -----------------------------------------------------------------------------
# On the CPU: the autograd Function and the chunk count
# -----------------------------------------------------------------------------
@pytest.mark.parametrize('batch, n_s', [(None, 1), (None, 2), (2, 1)],
                         ids=['one_row', 'two_rows', 'batch'])
def test_function_is_the_plain_route(batch, n_s):
    """The route's autograd Function on the CPU: the plain version's value
    bit for bit, and the same gradients in eigvals, dt and weights as
    autograd through the plain tables, for a random cotangent."""
    args = branch_inputs(batch, n_s, n_w=9)
    omega = args[0]
    leaves = [[x.clone().requires_grad_(True) for x in args[1:]]
              for _ in range(2)]
    got = numeric._K2Tables.apply(omega, *leaves[0])
    want = numeric._factored_weighted_lattice_plain(omega, *leaves[1])
    assert torch.equal(got, want)
    rng = np.random.default_rng(3)
    cot = torch.complex(_t(rng.standard_normal(want.shape)),
                        _t(rng.standard_normal(want.shape)))
    g_got = torch.autograd.grad(got, leaves[0], cot)
    g_want = torch.autograd.grad(want, leaves[1], cot)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)


@pytest.mark.parametrize('wrt', ['eigvals', 'dt', 'weights'])
def test_function_gradcheck(wrt):
    """torch.autograd.gradcheck of the Function at d = 3, G = 2, n_w = 5,
    one input at a time, away from the exact resonances (central
    differences across a branch switch would not be a derivative)."""
    rng = np.random.default_rng(5)
    omega = _t(np.geomspace(0.3, 6, 5))
    ev = _t(np.sort(rng.standard_normal((2, 3)) * 2, -1))
    dt = _t(rng.random(2) + 0.5)
    weights = _t(rng.random((2, 5)))
    args = {'eigvals': ev, 'dt': dt, 'weights': weights}

    def fn(x):
        kw = dict(args, **{wrt: x})
        return numeric._K2Tables.apply(omega, kw['eigvals'], kw['dt'],
                                       kw['weights'])
    assert torch.autograd.gradcheck(
        fn, (args[wrt].clone().requires_grad_(True),), fast_mode=True)


def test_backward_sub_chunks_hold_the_unchunked_gradient():
    """The backward rebuilds the tables a segment a sub-chunk in a budget
    of one byte, and all at once in the default one: the gradients in
    eigvals, dt and weights agree within 1e-13 of their largest entry;
    under a profiler the backward opens ff.so.tables.backward once a
    sub-chunk, twice and once, and no counter moves."""
    args = branch_inputs(2, 2, n_w=9)
    omega = args[0]
    rng = np.random.default_rng(11)
    shape = (2, 2, 2, 9, 9)
    cot = torch.complex(_t(rng.standard_normal(shape)),
                        _t(rng.standard_normal(shape)))
    grads, ranges = {}, {}
    for budget in (None, 1):
        leaves = [x.clone().requires_grad_(True) for x in args[1:]]
        before = dict(tracing.counts)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = numeric._K2Tables.apply(omega, *leaves, budget)
            grads[budget] = torch.autograd.grad(out, leaves, cot)
        assert dict(tracing.counts) == before
        ranges[budget] = sum(e.name() == 'ff.so.tables.backward' for e in
                             prof.profiler.kineto_results.events())
    assert numeric._shifts_chunk(args[1], 9, 2, 1, recompute=True) == 1
    assert ranges == {None: 1, 1: 2}
    for a, b in zip(grads[1], grads[None]):
        assert (a - b).abs().max() <= 1e-13 * b.abs().max()


def test_cpu_calls_take_the_plain_version():
    """On the CPU the shifts' weighted lattice is the plain version's,
    bit for bit, and launches nothing; the kernel's wrapper refuses CPU
    tensors."""
    args = branch_inputs(None, 2)
    before = k2_tables.launches
    assert torch.equal(numeric._factored_weighted_lattice(*args),
                       numeric._factored_weighted_lattice_plain(*args))
    assert k2_tables.launches == before
    with pytest.raises(ValueError, match='CUDA'):
        k2_tables.weighted_lattice(*args)


@pytest.mark.parametrize('change, error', [
    (lambda a: (a[0].float(), *a[1:]), TypeError),
    (lambda a: (a[0], a[1], a[2][..., :1], a[3]), ValueError),
    (lambda a: (a[0], a[1], a[2], a[3][:, :-1]), ValueError),
    (lambda a: (a[0][None], *a[1:]), ValueError)],
    ids=['float32', 'dt_shape', 'weights_width', 'omega_2d'])
def test_check_refuses(change, error):
    with pytest.raises(error):
        k2_tables.check(*change(branch_inputs(2, 1)))


@pytest.mark.parametrize('n_s, mixed, chunk', [
    (1, 0, 9), (1, 3 * 4 * 256 * 256, 8), (18, 0, 2)],
    ids=['one_row', 'cross_spectrum', 'every_row'])
def test_kernel_chunk_at_the_qft_batch(n_s, mixed, chunk):
    """The chunks of the kernel's route at the second-order ETM of the
    4-qubit QFT pulse (batch 4, 13 segments, d = 16, 1000 frequencies,
    18 noise operators, 256 basis elements) in a 4 GiB budget: the left
    planes, the folded right table, the product, ell and the sandwich's
    three (18, 256, 256) arrays a segment; the plain route keeps its 5
    and 1 (``test_shifts_chunk_at_the_qft_batch``)."""
    eigvals = torch.zeros(4, 13, 16)
    assert numeric._shifts_chunk(eigvals, 1000, n_s, 4 * 2**30, mixed,
                                 kernel=True, held=QFT4_HELD) \
        == chunk


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the K2 tables kernel has no CPU '
                    'mode; its route\'s Function and chunking are tested '
                    'above')
    return torch.device('cuda', 0)


CARD_CASES = {
    'cell_one_row': lambda dev: k2_cell_inputs(1, dev),
    'cell_every_row': lambda dev: k2_cell_inputs(18, dev),
    'branches_no_batch_one_row': lambda dev: branch_inputs(None, 1, dev),
    'branches_batch_every_row': lambda dev: branch_inputs(2, 3, dev),
}


@pytest.mark.gpu
@pytest.mark.parametrize('name', list(CARD_CASES))
def test_kernel_against_plain_on_card(name):
    """ell of the kernel's route against the plain version on the card,
    within 1e-13 of max|ell| (the module's note says why), one launch a
    call; the branch cases hit every branch."""
    device = _card()
    omega, eigvals, dt, weights = CARD_CASES[name](device)
    if name.startswith('branches'):
        assert all(_branches_hit(omega, eigvals, dt).values())
    want = numeric._factored_weighted_lattice_plain(omega, eigvals, dt,
                                                    weights)
    before = k2_tables.launches
    got = k2_tables.weighted_lattice(omega, eigvals, dt, weights)
    torch.cuda.synchronize()
    assert k2_tables.launches - before == 1
    assert got.shape == want.shape and got.dtype == torch.complex128
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    assert rel <= CARD_TOL, f'{name}: {rel:.3e} of max|ell| {scale:.3e}'


def _herm(n, d, rng):
    a = rng.standard_normal((n, d, d)) + 1j * rng.standard_normal((n, d, d))
    h = a + a.conj().transpose(0, 2, 1)
    return h - np.trace(h, axis1=1, axis2=2)[:, None, None] * np.eye(d) / d


@pytest.mark.gpu
def test_shifts_launch_once_a_chunk_on_card():
    """``numeric._second_order_diag_shifts`` on the card launches the
    tables kernel once a chunk (here 3 chunks of 2 segments), and its
    shifts equal the CPU's plain route within 1e-12 of the largest."""
    device = _card()
    rng = np.random.default_rng(7)
    d, G, batch = 4, 6, 2
    p = functional.PulseArrays(
        torch.tensor(_herm(2, d, rng)),
        torch.tensor(rng.standard_normal((batch, 2, G))),
        torch.tensor(_herm(2, d, rng)),
        torch.tensor(rng.random((batch, 2, G))),
        torch.tensor(1 - rng.random((batch, G))),
        Basis.ggm(d).tensor('cpu'))
    omega = _t(np.geomspace(0.1, 20, 40))
    shifts = {}
    for dev in ('cpu', device):
        q = functional.PulseArrays(*(x.to(dev) for x in p))
        w = omega.to(dev)
        eigvals, (_, n_t, b_t, ph, integral), _ = functional._prep(
            q, q.c_coeffs, q.n_coeffs, q.dt, w)
        step = numeric._ctrlmat_step_contract(n_t, integral, b_t, ph)
        weights = numeric._spectral_weights(1e-3 / w, w, 2)[:1]
        held = 3 * 2 * d ** 4
        per_chunk = batch * len(w) * 16 * (
            numeric._K2_KERNEL_TEMPS * d * d + 4 * d * d
            + math.ceil((2 * d ** 4 + held) / len(w)))
        budget = 2 * per_chunk if dev != 'cpu' else None
        before = k2_tables.launches
        shifts[str(dev)] = numeric._second_order_diag_shifts(
            eigvals, n_t, b_t, step, w, q.dt, weights, budget)
        if dev != 'cpu':
            torch.cuda.synchronize()
            assert k2_tables.launches - before == 3
    want = shifts['cpu']
    got = shifts[str(device)].cpu()
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
