"""The PyTorch port's second-order machinery against the JAX package's,
on the same numpy inputs: the K2 integral lattice (regular grids, and
grazing resonances against a 50-digit closed form), the
divided-difference coefficients, the second-order filter function from
scratch (batched total, per-segment caching, cumulative prefixes), the
frequency shifts of diagonal spectra without F^(2), and the object
API's ``order=2`` caching and prefix slicing.

Both sides run the native complex128 route on the CPU; they differ only
by the order of the sums, and near resonances by the port's
divided-difference branch, which the JAX f64 lattice lacks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import filter_functions_tpu_torch as fft
from filter_functions_tpu import numeric as jnumeric
from filter_functions_tpu_torch import functional, numeric, util
from testutil import make_pulse, rand_pulse_arrays
from torch_testutil import fft_cpu, record_lattice_rows


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.to_numpy() if hasattr(x, 'to_numpy') else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want, rel=1e-12):
    """|got - want| <= rel * max|want| elementwise."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _pair(d, n_dt, seed, n_nops=3):
    arrays = rand_pulse_arrays(d, n_dt, n_nops=n_nops,
                               local_rng=np.random.default_rng(seed))
    return make_pulse(arrays), make_pulse(arrays, cls=fft_cpu)


def _grids():
    """The regular grids of tests/test_precision.py::
    TestDoubleSingleK2Lattice: d in {2, 4, 8}, two scales, 40 log-spaced
    frequencies plus an exact y == 0 hit and an exact x == 0 column."""
    local = np.random.default_rng(7)
    cases = []
    for trial in range(6):
        d = [2, 4, 8][trial % 3]
        scale = [1.0, 1e3][trial % 2]
        ev = np.sort(local.normal(scale=scale, size=d))
        dE = (ev[:, None] - ev[None, :]).ravel()
        dt = abs(local.normal(scale=1 / scale)) + 0.1 / scale
        omega = np.concatenate([
            np.geomspace(1e-3 * scale, 1e3 * scale, 40),
            [-dE[dE != 0][0]], [0.0]])
        cases.append((omega, ev, dt))
    return cases


def _lattices(omega, ev, dt):
    """(port lattice, JAX lattice, series-branch mask), numpy."""
    want = _np(jnumeric._second_order_integral_single(
        jnp.asarray(omega), jnp.asarray(ev), jnp.asarray(dt)))
    got = numeric._second_order_integral_single(_t(omega), _t(ev), _t(dt))
    assert got.dtype == torch.complex128
    dE = (ev[:, None] - ev[None, :]).ravel()
    y = omega[:, None] + dE[None]                         # (o, mn)
    series = (y != 0) & (np.abs(y * dt) < numeric._SO_SMALL_Y)
    d = len(ev)
    mask = np.broadcast_to(series[:, None, :], (len(omega), d * d, d * d))
    return got.numpy(), want, mask.reshape(got.shape)


def _adjudicate(got, want, omega, ev, dt, mpmath, count=8):
    """Worst error of *got* and *want* against the 50-digit closed form
    (frac(x) - frac(z))/y over the *count* entries where they differ
    most, relative to max|I|."""
    d = len(ev)
    dE = (ev[:, None] - ev[None, :]).ravel()

    def frac(u):
        if u == 0:
            return mpmath.mpc(0, dt)
        return mpmath.expm1(mpmath.mpc(0, 1) * u * dt) / u

    scale = np.abs(want).max()
    worst_got, worst_want = 0.0, 0.0
    diff = np.abs(got - want)
    for flat in np.argsort(diff.ravel())[::-1][:count]:
        o, i, j, m, n = np.unravel_index(flat, got.shape)
        x = mpmath.mpf(dE[i * d + j]) - mpmath.mpf(omega[o])
        y = mpmath.mpf(omega[o]) + mpmath.mpf(dE[m * d + n])
        z = mpmath.mpf(dE[i * d + j]) + mpmath.mpf(dE[m * d + n])
        assert y != 0
        exact = complex((frac(x) - frac(z)) / y)
        worst_got = max(worst_got, abs(got[o, i, j, m, n] - exact) / scale)
        worst_want = max(worst_want,
                         abs(want[o, i, j, m, n] - exact) / scale)
    return worst_got, worst_want


@pytest.mark.parametrize('case', range(6))
def test_lattice_matches_jax_on_regular_grids(case):
    """K2 against the JAX f64 lattice within 1e-12 max|I| wherever both
    evaluate the same closed form; on the entries of the port's series
    branch (0 < |y dt| < 1e-2) the JAX lattice's cancelling general
    form is off by up to 5.4e-12 max|I| (measured against the
    50-digit closed form, next test), and the two agree within 1e-10."""
    omega, ev, dt = _grids()[case]
    got, want, series = _lattices(omega, ev, dt)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[~series], want[~series], rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(got[series], want[series], rtol=0,
                               atol=1e-10 * scale)


@pytest.mark.parametrize('case', range(6))
def test_lattice_series_branch_on_regular_grids(case):
    """Where the port and the JAX lattice differ most on the grids
    above, the port is within 1e-14 max|I| of the 50-digit closed form
    (measured <= 4.4e-16)."""
    mpmath = pytest.importorskip('mpmath')
    omega, ev, dt = _grids()[case]
    got, want, _ = _lattices(omega, ev, dt)
    with mpmath.workdps(50):
        worst, _ = _adjudicate(got, want, omega, ev, dt, mpmath)
    assert worst < 1e-14, worst


def test_lattice_at_grazing_resonance():
    """At |y dt| ~ 1e-10 the port's lattice is within 1e-8 of the
    50-digit closed form (relative to max|I|; measured ~1e-16), where
    the JAX f64 lattice's cancelling general form is more than 100x
    further off (its own test measured 2.7e-4)."""
    mpmath = pytest.importorskip('mpmath')
    local = np.random.default_rng(3)
    d = 4
    ev = np.sort(local.normal(size=d))
    dE = (ev[:, None] - ev[None, :]).ravel()
    dt = 0.7
    nz = dE[dE != 0]
    omega = -nz + local.normal(scale=1e-10 / dt, size=nz.size)
    got, want, _ = _lattices(omega, ev, dt)
    with mpmath.workdps(50):
        worst, worst_jax = _adjudicate(got, want, omega, ev, dt, mpmath)
    assert worst < 1e-8, worst
    assert worst_jax > 100 * worst, (worst_jax, worst)


def test_divided_difference_coefficients_match_jax():
    """D_k(u) of both series and closed-form branches against the JAX
    package's within 1e-12 of their largest value (k = 0..5), at
    |u dt| <= 0.15 (series) and |u dt| >= 1.55 (closed form).  Between
    those the closed form of both packages carries a rounding error
    ~eps (k+1)!/|u dt|^{k+1}, which (y dt)^k suppresses where the
    lattice uses it."""
    a = np.concatenate([np.linspace(-0.1, 0.1, 11), np.linspace(1.6, 4, 15),
                        -np.linspace(1.6, 4, 15)])
    b = np.array([-0.05, 0.0, 0.05])
    dt = 0.9
    w = a[:, None] + b[None]
    want = _np(jnumeric._frac_divdiff_coeffs(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(dt), 6,
        jnp.sin(jnp.asarray(w)), jnp.cos(jnp.asarray(w))))
    got = numeric._frac_divdiff_coeffs(_t(a), _t(b), _t(dt), 6,
                                       _t(np.sin(w)), _t(np.cos(w)))
    assert got.shape == (6, 41, 3)
    for k in range(6):
        _close(got[k], want[k])


def test_lattice_takes_leading_segment_axes():
    """A batch of segments gives the per-segment lattices within
    1e-15 max|I| (only einsum blocking differs)."""
    ev = _t(np.sort(np.random.default_rng(1).normal(size=(3, 3)), -1))
    dt = _t([0.3, 0.7, 1.2])
    omega = _t(np.geomspace(0.05, 20, 9))
    batched = numeric._second_order_integral_single(omega, ev, dt)
    assert batched.shape == (3, 9, 3, 3, 3, 3)
    for g in range(3):
        single = numeric._second_order_integral_single(omega, ev[g], dt[g])
        _close(batched[g], single, 1e-15)


def test_trapezoid_weights_match_jax():
    omega = np.geomspace(0.1, 10, 17)
    got = numeric.trapezoid_weights(_t(omega))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jnumeric.trapezoid_weights(omega)),
        rtol=1e-15)
    f = np.cos(omega)
    np.testing.assert_allclose((got * _t(f)).sum().item(),
                               np.trapezoid(f, omega), rtol=1e-14)


def _from_scratch(pulse, omega, module, **kw):
    pulse.diagonalize()
    return module.calculate_second_order_filter_function_from_scratch(
        pulse.eigvals, pulse.eigvecs, pulse.propagators, omega, pulse.basis,
        pulse.n_opers_dev, pulse.n_coeffs, pulse.dt, **kw)


@pytest.mark.parametrize('d,n_dt,n_omega', [(2, 4, 20), (3, 5, 32),
                                            (4, 3, 16)])
def test_second_order_filter_function_matches_jax(d, n_dt, n_omega):
    """K10 total (batched matmuls), with per-segment caching, and the
    cumulative prefixes: within 1e-12 max|F2| of the JAX package, and
    the lattices and complete steps it caches likewise."""
    jp, p = _pair(d, n_dt, 10 + d)
    omega = np.geomspace(0.1, 20, n_omega)
    want, jint = _from_scratch(jp, omega, jnumeric,
                               cache_intermediates=True,
                               cache_cumulative=True)
    got = _from_scratch(p, omega, numeric)
    assert got.shape == (3, 3, d * d, d * d, n_omega)
    assert got.dtype == torch.complex128
    _close(got, want)
    cached, tint = _from_scratch(p, omega, numeric, cache_intermediates=True,
                                 cache_cumulative=True)
    _close(cached, want)
    for key in ('second_order_integral', 'second_order_complete_steps',
                'filter_function_2_step_cumulative', 'control_matrix_step'):
        _close(tint[key], jint[key])
    # the last prefix is the whole pulse
    _close(tint['filter_function_2_step_cumulative'][-1], want)


def test_second_order_chunking_and_intermediates():
    """A memory budget of one segment per chunk, and step terms taken
    from the first-order cache, leave F2 within 1e-13 max|F2|."""
    _, p = _pair(3, 5, 21)
    omega = np.geomspace(0.1, 20, 24)
    whole = _from_scratch(p, omega, numeric)
    chunked = _from_scratch(p, omega, numeric, budget_bytes=1)
    _close(chunked, whole, 1e-13)
    p.get_control_matrix(omega, cache_intermediates=True)
    reused = _from_scratch(p, omega, numeric,
                           intermediates=dict(p.intermediates))
    _close(reused, whole, 1e-13)


def _shift_inputs(seed=31, n_omega=30):
    """A random d = 3 pulse of 4 segments and 3 noise operators: the
    arguments of ``numeric._second_order_diag_shifts`` before the
    weights (eigvals, n_t, b_t, step, omega, dt)."""
    _, p = _pair(3, 4, seed)
    omega = _t(np.geomspace(0.1, 20, n_omega))
    p.diagonalize()
    n_t, b_t, step, _ = numeric._second_order_step_terms(
        p.eigvals, p.eigvecs, p.propagators, omega, p.basis.tensor('cpu'),
        p.n_opers_dev, _t(p.n_coeffs), _t(p.dt), _t(p.t))
    return p.eigvals, n_t, b_t, step, omega, _t(p.dt)


@pytest.mark.parametrize('kind', ['shared', 'per_operator', 'one_row'])
def test_diag_shifts_match_integrated_f2(kind):
    """The frequency shifts of a diagonal spectrum without F2 (the
    functional path's route) against the integral of the full F2's
    a == b diagonal, within 1e-12 max|Delta|; with a memory budget of
    one segment per chunk equal to the single chunk within 1e-13; also
    batched over two pulses, each equal to its single evaluation.  A
    shared spectrum as three equal rows of weights ('shared') or as the
    one row that serves all three operators ('one_row')."""
    eigvals, n_t, b_t, step, omega, dt = _shift_inputs()
    s = 1e-3 / omega
    if kind == 'per_operator':
        s = torch.outer(_t([1.0, 0.5, 2.0]), s)
    weights = numeric._spectral_weights(s, omega, 3)
    if kind == 'one_row':
        weights = weights[:1]
    got = numeric._second_order_diag_shifts(eigvals, n_t, b_t, step,
                                            omega, dt, weights)
    f2 = numeric._second_order_total(
        eigvals, n_t, b_t, step,
        numeric._pad_cumulative(step, step.cumsum(-4)[..., :-1, :, :, :]),
        omega, dt)
    want = numeric._integrate_2pi(numeric._get_integrand(
        s, omega, np.arange(3), 'total', 'generalized', filter_function=f2),
        omega)
    _close(got.real, want)
    assert numeric._factored_chunk(eigvals, 30, 0) == len(eigvals)
    assert numeric._factored_chunk(eigvals, 30, 0, budget_bytes=1) == 1
    chunked = numeric._second_order_diag_shifts(
        eigvals, n_t, b_t, step, omega, dt, weights, budget_bytes=1)
    _close(chunked, got, 1e-13)
    stacked = numeric._second_order_diag_shifts(
        *map(_two, (eigvals, n_t, b_t, step)), omega, _two(dt), weights)
    torch.testing.assert_close(stacked[0], got, rtol=0,
                               atol=1e-15 * got.abs().max().item())


def _two(x):
    """A batch of two: *x* and *x* reversed along its first axis."""
    return torch.stack([x, x.flip(0)])


@pytest.mark.parametrize('budget_bytes', [None, 1], ids=['whole', 'chunked'])
@pytest.mark.parametrize('batched', [False, True], ids=['single', 'batched'])
def test_diag_shifts_one_row_equals_equal_rows(batched, budget_bytes,
                                               monkeypatch):
    """A spectrum shared by the three noise operators, given as its one
    row of weights (one weighted K2 lattice for all operators) and as
    three materialised equal rows (one lattice each): the shifts agree
    within 1e-13 max|Delta|, for one pulse and a batch of two, in one
    chunk and in chunks of one segment, and every chunk's weighted
    lattice has one row for the one row and three for the equal rows."""
    args = _shift_inputs(seed=33)
    if batched:
        args = (*map(_two, args[:4]), args[4], _two(args[5]))
    omega = args[4]
    rows = numeric._spectral_weights(2e-3 / omega ** 0.8, omega, 3)
    assert rows.stride(0) != 0
    built = record_lattice_rows(monkeypatch)
    one = numeric._second_order_diag_shifts(*args, rows[:1], budget_bytes)
    assert built and set(built) == {1}
    built.clear()
    equal = numeric._second_order_diag_shifts(*args, rows, budget_bytes)
    assert built and set(built) == {3}
    _close(one, equal, 1e-13)



@pytest.mark.parametrize('budget_bytes', [None, 1],
                         ids=['one_chunk', 'chunked'])
@pytest.mark.parametrize('batched', [False, True], ids=['single', 'batched'])
@pytest.mark.parametrize('n_s', [1, 3], ids=['one_row', 'per_operator'])
def test_running_complete_steps_equal_the_cumulative_formula(
        n_s, batched, budget_bytes):
    """The complete steps accumulated segment by segment on a running
    weighted sum (``numeric._complete_step_shifts``) equal the formula
    on the padded cumulative control matrices within 1e-13 max|Delta|,
    for one row of weights and one a noise operator, one pulse and a
    batch of two; and the whole shifts, in one chunk and in chunks of
    one segment, equal that formula plus the incomplete steps (the
    shifts of zero per-step control matrices)."""
    eigvals, n_t, b_t, step, omega, dt = _shift_inputs(seed=35)
    if batched:
        eigvals, n_t, b_t, step, dt = map(_two, (eigvals, n_t, b_t, step,
                                                 dt))
    s = torch.outer(_t([1.0, 0.5, 2.0]), 2e-3 / omega ** 0.8)
    weights = numeric._spectral_weights(s, omega, 3)[:n_s]
    cumul_padded = numeric._pad_cumulative(
        step, step.cumsum(-4)[..., :-1, :, :, :])
    want = ((step * weights[:, None, :]) @ cumul_padded.mH).sum(
        -4).conj().resolve_conj()
    _close(numeric._complete_step_shifts(step, weights), want, 1e-13)

    def shifts(ctrlmat_step):
        return numeric._second_order_diag_shifts(
            eigvals, n_t, b_t, ctrlmat_step, omega, dt, weights,
            budget_bytes)
    _close(shifts(step), want + shifts(torch.zeros_like(step)), 1e-13)


class _Outputs(TorchDispatchMode):
    """Records every operator that is not a view: its name and the
    element counts of the tensors it returns."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.ops.append((func.name(), {
                t.numel() for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)}))
        return out


@pytest.mark.parametrize('call', ['shifts', 'etm', 'etm_cross'])
def test_diagonal_shifts_copy_no_step_matrices(call, monkeypatch):
    """Past ``numeric._ctrlmat_step_contract``, the diagonal route makes
    no tensor of B_step's size, nor of one row's segment, calls no
    cumsum and reaches no ``_pad_cumulative``: the complete steps read
    B_step in place.  A batch of two d = 3 pulses of 4 segments, 3
    noise operators and 23 frequencies, where nothing else has either
    size; the shifts alone ('shifts', one row of weights), the whole
    ETM ('etm', a spectrum per noise operator) and the whole ETM of a
    cross-spectrum ('etm_cross', two of the three operators correlated),
    whose route mixes their rows on one side.  The padded cumulative
    sums, built after each call, show that the records see them."""
    arrays = rand_pulse_arrays(3, 4, n_nops=3,
                               local_rng=np.random.default_rng(37))
    pulse = make_pulse(arrays, cls=fft_cpu)
    p = functional.make_pulse_arrays(pulse)
    p = p._replace(c_coeffs=torch.stack([p.c_coeffs, 0.9 * p.c_coeffs]),
                   n_coeffs=torch.stack([p.n_coeffs] * 2),
                   dt=torch.stack([p.dt, 1.1 * p.dt]))
    omega = _t(np.geomspace(0.1, 20, 23))
    spectrum = torch.outer(_t([1.0, 0.5, 2.0]), 1e-3 / omega)
    if call == 'etm_cross':
        spectrum = torch.diag_embed(spectrum.T).movedim(0, -1) + 0j
        spectrum[0, 2] = (0.3 + 0.2j) * 1e-3 / omega
        spectrum[2, 0] = spectrum[0, 2].conj()
    mode, steps, padded = _Outputs(), [], []
    contract, pad = numeric._ctrlmat_step_contract, numeric._pad_cumulative

    def recorded_contract(*args):
        step = contract(*args)
        steps.append((len(mode.ops), step))
        return step

    def recorded_pad(*args):
        padded.append(len(mode.ops))
        return pad(*args)
    monkeypatch.setattr(numeric, '_ctrlmat_step_contract', recorded_contract)
    monkeypatch.setattr(numeric, '_pad_cumulative', recorded_pad)
    if call == 'shifts':
        eigvals, (_, n_t, b_t, ph, integral), _ = functional._prep(
            p, p.c_coeffs, p.n_coeffs, p.dt, omega)
        step = numeric._ctrlmat_step_contract(n_t, integral, b_t, ph)
        weights = numeric._spectral_weights(spectrum[0], omega, 3)
        with mode:
            numeric._second_order_diag_shifts(eigvals, n_t, b_t, step, omega,
                                              p.dt, weights)
        start = 0
    else:
        with mode:
            functional._etm_core(p, spectrum, omega, pulse.basis, True)
        start = steps[-1][0]
    step = steps[-1][1]
    row_segment = step[0, 0].numel()
    assert step.shape == (2, 4, 3, 9, 23) and row_segment == 3 * 9 * 23
    after = mode.ops[start:]
    sized = [name for name, sizes in after
             if sizes & {step.numel(), row_segment}]
    cumsums = [name for name, _ in after if 'cumsum' in name]
    assert after and not sized and not cumsums and not padded
    with mode:
        numeric._pad_cumulative(step, step.cumsum(-4)[..., :-1, :, :, :])
    seen = mode.ops[start + len(after):]
    assert padded and [name for name, _ in seen if 'cumsum' in name]
    assert [name for name, sizes in seen if step.numel() in sizes]


def _cross_profiles(c02, omega):
    """The profiles of a cross-spectrum of three noise operators at
    *omega*: diagonal (1, 0.5, 2) 1e-3 / omega, and S_02 = conj(S_20) =
    *c02* 1e-3 / omega, so that operators 0 and 2 mix with real or
    complex factors."""
    s = torch.diag_embed(torch.outer(_t([1.0, 0.5, 2.0]), 1e-3 / omega).T
                         ).movedim(0, -1) + 0j
    s[0, 2] = c02 * 1e-3 / omega
    s[2, 0] = s[0, 2].conj()
    return numeric._spectrum_profiles(s, omega, 3)


def _cumulative_complete_steps(step, weights, profiles=None):
    """The complete steps on the padded cumulative control matrices,
    sum_g conj(B_g) (W C_g + mixed C_g)^T, in PyTorch operations under
    autograd, with no Function."""
    cumul = numeric._pad_cumulative(step, step.cumsum(-4)[..., :-1, :, :, :])
    cw = cumul * weights.to(step.dtype)[:, None, :]
    if profiles is not None:
        cw = cw.index_add(-3, profiles.corr, profiles.mix(
            cumul.index_select(-3, profiles.corr)))
    return (step.conj() @ cw.mT).sum(-4)


def _gradients(fn, inputs, cotangent):
    """The vector-Jacobian products of fn(*inputs) with *cotangent* in
    each of *inputs*, and its value."""
    inputs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*inputs)
    return out.detach(), torch.autograd.grad(out, inputs, cotangent)


@pytest.mark.parametrize('batched', [False, True], ids=['single', 'batched'])
@pytest.mark.parametrize('spectrum', [
    'one_row', 'per_operator', 'real_mixing', 'complex_mixing'])
def test_complete_steps_gradient_equals_the_cumulative_formula(spectrum,
                                                               batched):
    """The gradients of the complete steps' running sum
    (``numeric._CompleteStepShifts``) equal autograd of the formula on
    the padded cumulative control matrices within 1e-12 of their largest
    entry, for one pulse and a batch of two: in B_step and the weights
    of a diagonal spectrum, one row of weights or one a noise operator;
    with a cross-spectrum's profiles, whose mixing factors are real or
    complex, in B_step, the diagonal's weights and the mixing's weights.
    The weights' gradient alone, with B_step a constant, is the same."""
    step = _shift_inputs(seed=35)[3]
    if batched:
        step = _two(step)
    omega = _t(np.geomspace(0.1, 20, 30))
    profiles = None
    if spectrum.endswith('mixing'):
        profiles = _cross_profiles(
            0.4 if spectrum == 'real_mixing' else 0.4 + 0.3j, omega)
        assert profiles.mixed and profiles.corr.tolist() == [0, 2]
        assert (profiles.mixing.imag != 0).any() == (spectrum != 'real_mixing')
        inputs = (step, profiles.diagonal, profiles.mix_weights)
    else:
        s = torch.outer(_t([1.0, 0.5, 2.0]), 2e-3 / omega ** 0.8)
        n_s = 1 if spectrum == 'one_row' else 3
        inputs = (step, numeric._spectral_weights(s, omega, 3)[:n_s])

    def running(b, w, mw=None):
        p = profiles and profiles._replace(mix_weights=mw)
        return numeric._complete_step_shifts(b, w, p)

    def cumulative(b, w, mw=None):
        p = profiles and profiles._replace(mix_weights=mw)
        return _cumulative_complete_steps(b, w, p)
    cotangent = torch.randn((*step.shape[:-4], 3, 9, 9), dtype=step.dtype,
                            generator=torch.Generator().manual_seed(5))
    got_value, got = _gradients(running, inputs, cotangent)
    want_value, want = _gradients(cumulative, inputs, cotangent)
    _close(got_value, want_value, 1e-13)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, 1e-12)
    _, (weights_only,) = _gradients(
        lambda w: running(step, w, *inputs[2:]), inputs[1:2], cotangent)
    _close(weights_only, want[1], 1e-12)


@pytest.mark.parametrize('mixed', [False, True], ids=['diagonal', 'mixed'])
def test_complete_steps_gradcheck(mixed):
    """torch.autograd.gradcheck of the complete steps at a tiny complex
    size (3 segments, 3 noise operators, 2 basis elements, 4
    frequencies, B_step in its layout), in B_step and the weights, and
    with a cross-spectrum in the mixing's weights too."""
    gen = torch.Generator().manual_seed(8)
    step = torch.randn(3, 4, 3, 2, dtype=torch.complex128,
                       generator=gen).movedim(-3, -1)
    omega = _t(np.geomspace(0.1, 20, 4))
    if mixed:
        profiles = _cross_profiles(0.4 + 0.3j, omega)
        inputs = (step, profiles.diagonal, profiles.mix_weights)

        def fn(b, w, mw):
            return numeric._complete_step_shifts(
                b, w, profiles._replace(mix_weights=mw))
    else:
        inputs = (step, torch.rand(1, 4, dtype=torch.float64,
                                   generator=gen))
        fn = numeric._complete_step_shifts
    inputs = [x.detach().clone().requires_grad_(True) for x in inputs]
    assert torch.autograd.gradcheck(fn, inputs)


@pytest.mark.parametrize('mixed', [False, True], ids=['diagonal', 'mixed'])
def test_complete_steps_forward_is_that_without_a_gradient(mixed):
    """The complete steps' values with a gradient asked for are
    ``torch.equal`` to those without."""
    step = _two(_shift_inputs(seed=35)[3])
    omega = _t(np.geomspace(0.1, 20, 30))
    profiles = _cross_profiles(0.4 + 0.3j, omega) if mixed else None
    weights = profiles.diagonal if mixed else \
        numeric._spectral_weights(1e-3 / omega, omega, 1)
    plain = numeric._complete_step_shifts(step, weights, profiles)
    traced = numeric._complete_step_shifts(
        step.clone().requires_grad_(True), weights, profiles)
    assert not plain.requires_grad and traced.requires_grad
    assert torch.equal(traced.detach(), plain)


def test_complete_steps_backward_writes_one_step_gradient():
    """The backward of the complete steps makes exactly one tensor of
    B_step's element count, by no ``zeros`` or ``fill_``: the gradient,
    written once, segment by segment, not one zero-filled tensor per
    slice of B_step; the forward saves only its inputs, no running
    buffer of a segment's size.  A batch of two d = 3 pulses of 4
    segments, 3 noise operators and 30 frequencies; the cumulative
    formula's backward, recorded the same way, shows that the records
    see tensors of that count."""
    step = _two(_shift_inputs(seed=35)[3]).detach().requires_grad_(True)
    omega = _t(np.geomspace(0.1, 20, 30))
    weights = numeric._spectral_weights(1e-3 / omega, omega, 1)
    segments = {step[:, 0].numel(), step[0, 0].numel()}
    saved = []

    def pack(x):
        saved.append(x.numel())
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = numeric._complete_step_shifts(step, weights)
    assert saved and set(saved) <= {step.numel(), weights.numel()}
    assert not set(saved) & segments
    mode = _Outputs()
    with mode:
        grad, = torch.autograd.grad(out, step, torch.ones_like(out))
    assert grad.shape == step.shape
    sized = [name for name, sizes in mode.ops if step.numel() in sizes]
    assert len(sized) == 1 and 'empty' in sized[0]
    assert not [name for name in sized
                if 'zero' in name or 'fill' in name]
    out = _cumulative_complete_steps(step, weights)
    with mode:
        torch.autograd.grad(out, step, torch.ones_like(out))
    assert len([name for name, sizes in mode.ops[len(sized):]
                if step.numel() in sizes]) > 1


@pytest.mark.parametrize('spectrum, n_s', [
    (torch.ones(30), 1), (torch.ones(1, 30), 1), (torch.ones(3, 30), 3),
    (torch.ones(30).expand(3, 30), 1), (np.ones((3, 30)), 3)],
    ids=['1d', 'one_row', 'equal_rows', 'expanded', 'numpy_rows'])
def test_distinct_rows_from_shape_and_strides(spectrum, n_s):
    """n_s of a parsed diagonal spectrum comes from its shape and
    strides: 1 for one row, given 1-d, (1, n_w) or as an expanded view;
    one a noise operator for materialised rows, equal or not."""
    s = util.parse_spectrum(spectrum, torch.ones(30), np.arange(3))
    assert numeric._distinct_rows(s) == n_s


@pytest.mark.parametrize('n_s, recompute, chunk', [
    (1, False, 5), (18, False, 1), (1, True, 3), (18, True, 1)])
def test_shifts_chunk_at_the_qft_batch(n_s, recompute, chunk):
    """The shifts' chunks at the second-order ETM of the 4-qubit QFT
    pulse (batch 4, 13 segments, d = 16, 1000 frequencies) in a 4 GiB
    budget: 5 segments a chunk with one row of weights, 1 with 18; the
    tables rebuilt under autograd (the backward of ``_K2Tables``), 78
    tables a segment-row with one row of weights (4 x 78 x 4.1 MB a
    segment): 3 segments a sub-chunk, 1 with 18 rows."""
    eigvals = torch.zeros(4, 13, 16)
    assert numeric._shifts_chunk(eigvals, 1000, n_s, budget_bytes=4 * 2**30,
                                 recompute=recompute) == chunk


def test_object_order_two_matches_jax():
    """get_filter_function(order=2) caches F2 (within 1e-12 of JAX's),
    a second call computes nothing, and omega changes invalidate it."""
    jp, p = _pair(2, 5, 41)
    omega = np.geomspace(0.1, 20, 25)
    want = jp.get_filter_function(omega, order=2)
    got = p.get_filter_function(omega, order=2)
    _close(got, want)
    assert p.is_cached('second order filter function')
    assert p.get_filter_function(omega, order=2) is got
    p.get_filter_function(omega[:-1], order=2)
    assert p.get_filter_function(omega[:-1], order=2).shape[-1] == 24


def test_prefix_slice_reuses_second_order_cumulative():
    """pulse[:i] inherits F2 from filter_function_2_step_cumulative, and
    it equals F2 from scratch within 1e-13 max|F2| (as
    tests/test_sequencing.py pins for the JAX package)."""
    _, p = _pair(3, 5, 51)
    omega = np.geomspace(0.1, 20, 11)
    p.cache_control_matrix(omega, cache_intermediates=True)
    p.cache_filter_function(omega, order=2, cache_intermediates=True,
                            cache_second_order_cumulative=True)
    assert p.is_cached('second_order_integral')
    for i in range(1, len(p)):
        sliced = p[:i]
        assert sliced.is_cached('filter_function_2')
        f2 = sliced.get_filter_function(omega, order=2)
        sliced.cleanup('all')
        _close(f2, sliced.get_filter_function(omega, order=2), 1e-13)
