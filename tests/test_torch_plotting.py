"""The port's plotting (filter_functions_tpu_torch.plotting) against the
JAX package's, on the Agg backend, with tests/_qutip_stub.py standing in
for qutip.

Each case draws the same pulse (built from the same numpy arrays in both
packages, on the CPU) with both modules and compares what was drawn: the
line data within 1e-12 of their largest entry, and the labels, titles,
scales and tick labels exactly.  The classes mirror tests/test_plotting.py.
"""
import importlib
import sys

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip(
    'matplotlib', reason='plotting needs matplotlib')
matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
from cycler import cycler as mpl_cycler  # noqa: E402

import filter_functions_tpu as ff  # noqa: E402
import filter_functions_tpu_torch as fft  # noqa: E402
from filter_functions_tpu import plotting as jplotting  # noqa: E402
from filter_functions_tpu_torch import plotting  # noqa: E402
from testutil import make_pulse, rand_pulse_arrays  # noqa: E402
from torch_testutil import fft_cpu  # noqa: E402


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close('all')


def _both(d=2, n_dt=3, seed=0):
    """The same random pulse in (JAX, port)."""
    arrays = rand_pulse_arrays(d, n_dt, local_rng=np.random.default_rng(seed))
    return make_pulse(arrays), make_pulse(arrays, cls=fft_cpu)


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _same_axes(got, want):
    """Same lines (data within 1e-12, labels, styles), scales, axis
    labels, title and tick labels."""
    assert len(got.lines) == len(want.lines)
    for g, w in zip(got.lines, want.lines):
        _close(g.get_xdata(), w.get_xdata())
        _close(g.get_ydata(), w.get_ydata())
        assert g.get_label() == w.get_label()
        assert g.get_color() == w.get_color()
        assert g.get_linestyle() == w.get_linestyle()
    for attr in ('get_xscale', 'get_yscale', 'get_xlabel', 'get_ylabel',
                 'get_title'):
        assert getattr(got, attr)() == getattr(want, attr)(), attr
    assert [t.get_text() for t in got.get_xticklabels()] == \
        [t.get_text() for t in want.get_xticklabels()]
    _close(got.get_xlim(), want.get_xlim())


class TestPulseTrain:
    @pytest.mark.parametrize('kw', [
        {}, dict(c_oper_identifiers=slice(0, 2)),
        dict(cycler=mpl_cycler('color', ['r', 'g', 'b']),
             plot_kw=dict(linewidth=3))], ids=['default', 'subset', 'kw'])
    def test_lines_equal_jax(self, kw):
        jp, p = _both(n_dt=5)
        if 'c_oper_identifiers' in kw:
            kw = dict(c_oper_identifiers=p.c_oper_identifiers[
                kw['c_oper_identifiers']])
        _, want, jlegend = jplotting.plot_pulse_train(jp, **kw)
        _, got, legend = plotting.plot_pulse_train(p, **kw)
        _same_axes(got, want)
        assert [t.get_text() for t in legend.get_texts()] == \
            [t.get_text() for t in jlegend.get_texts()]

    def test_fig_axes_reuse_and_bad_identifier(self):
        _, p = _both(n_dt=4)
        fig0 = plt.figure()
        assert plotting.plot_pulse_train(p, fig=fig0)[0] is fig0
        _, ax1 = plt.subplots()
        assert plotting.plot_pulse_train(p, axes=ax1)[1] is ax1
        with pytest.raises(ValueError):
            plotting.plot_pulse_train(p, c_oper_identifiers=['nonexistent'])


class TestFilterFunction:
    def test_cached_omega_and_sampled_default(self):
        """With cached frequencies (a tensor on the pulse's device) and
        without, the same lines as JAX's."""
        jp, p = _both(n_dt=4)
        omega = np.linspace(0.5, 10, 17)
        jp.cache_filter_function(omega)
        p.cache_filter_function(omega)
        assert isinstance(p.omega, torch.Tensor)
        _same_axes(plotting.plot_filter_function(p)[1],
                   jplotting.plot_filter_function(jp)[1])
        jp, p = _both(n_dt=4, seed=1)
        _same_axes(plotting.plot_filter_function(p)[1],
                   jplotting.plot_filter_function(jp)[1])

    @pytest.mark.parametrize('xscale', ['log', 'linear'])
    @pytest.mark.parametrize('yscale', ['log', 'linear'])
    @pytest.mark.parametrize('in_tau', [True, False])
    def test_scales_and_units(self, xscale, yscale, in_tau):
        jp, p = _both()
        omega = np.linspace(0.5, 10, 11)
        kw = dict(xscale=xscale, yscale=yscale, omega_in_units_of_tau=in_tau)
        got = plotting.plot_filter_function(p, omega, **kw)[1]
        _same_axes(got, jplotting.plot_filter_function(jp, omega, **kw)[1])
        np.testing.assert_allclose(got.lines[0].get_xdata(),
                                   omega * (p.tau if in_tau else 1.0))

    def test_identifier_subset_kwargs_and_errors(self):
        jp, p = _both()
        omega = torch.linspace(0.5, 10, 11, dtype=torch.float64)
        kw = dict(n_oper_identifiers=p.n_oper_identifiers[1:],
                  cycler=mpl_cycler('color', ['k', 'm']),
                  plot_kw=dict(linestyle='--'))
        _same_axes(plotting.plot_filter_function(p, omega, **kw)[1],
                   jplotting.plot_filter_function(jp, omega.numpy(), **kw)[1])
        with pytest.raises(ValueError):
            plotting.plot_filter_function(p, np.linspace(0.5, 2, 5),
                                          n_oper_identifiers=['bogus'])


def _pc_pair(omega):
    """Two pulses with shared noise operators, concatenated with pulse
    correlations, in (JAX, port)."""
    rng = np.random.default_rng(2)
    base = rand_pulse_arrays(2, 3, local_rng=rng)
    out = []
    for mod, cls in ((ff, None), (fft, fft_cpu)):
        pulses = []
        for k in range(2):
            arr = rand_pulse_arrays(2, 3, local_rng=np.random.default_rng(k))
            p = make_pulse((arr[0], arr[1], arr[2], base[3], base[4], arr[5],
                            arr[6]), cls=cls)
            p.cache_filter_function(omega)
            pulses.append(p)
        out.append(mod.concatenate(pulses, calc_pulse_correlation_FF=True))
    return out


class TestPulseCorrelationFF:
    def test_grid_equal_jax(self):
        omega = np.linspace(0.5, 10, 11)
        jc, c = _pc_pair(omega)
        for kw in ({}, dict(xscale='linear', yscale='log',
                            omega_in_units_of_tau=False,
                            plot_kw=dict(alpha=0.5))):
            fig, got, _ = plotting.plot_pulse_correlation_filter_function(
                c, **kw)
            _, want, _ = jplotting.plot_pulse_correlation_filter_function(
                jc, **kw)
            assert got.shape == want.shape == (2, 2)
            for g, w in zip(got.ravel(), want.ravel()):
                _same_axes(g, w)
        fig2, _, _ = plotting.plot_pulse_correlation_filter_function(
            c, fig=fig)
        assert fig2 is fig

    def test_uncached_raises(self):
        _, p = _both()
        with pytest.raises(fft.util.CalculationError):
            plotting.plot_pulse_correlation_filter_function(p)


class TestCumulantFunction:
    @pytest.mark.parametrize('kw', [
        {}, dict(colorscale='log'), dict(colorscale='log', linthresh=1e-8),
        dict(second_order=True),
        dict(n_oper_identifiers='first', basis_labels=['I', 'X', 'Y', 'Z'],
             basis_labelsize=6, cmap='viridis', cbar_label='K',
             cbar_labelsize=8, imshow_kw=dict(interpolation='nearest'))],
        ids=['default', 'log', 'linthresh', 'second_order', 'labels'])
    def test_images_equal_jax(self, kw):
        """The images are JAX's within 1e-12 of the largest entry."""
        jp, p = _both()
        omega = np.linspace(0.5, 10, 21)
        if kw.get('n_oper_identifiers') == 'first':
            kw = {**kw, 'n_oper_identifiers': p.n_oper_identifiers[:1]}
        _, got = plotting.plot_cumulant_function(p, 1e-2 / omega, omega, **kw)
        _, want = jplotting.plot_cumulant_function(jp, 1e-2 / omega, omega,
                                                   **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.images[0].get_array(), w.images[0].get_array())
            assert g.get_title() == w.get_title()
            assert [t.get_text() for t in g.get_xticklabels()] == \
                [t.get_text() for t in w.get_xticklabels()]

    def test_precomputed_grid_reuse_and_errors(self):
        _, p = _both()
        omega = np.linspace(0.5, 10, 11)
        k = fft.numeric.calculate_cumulant_function(p, 1e-2 / omega, omega)
        fig, grid = plotting.plot_cumulant_function(cumulant_function=k)
        assert len(grid) == 3
        assert len(plotting.plot_cumulant_function(
            cumulant_function=k[0])[1]) == 1
        assert plotting.plot_cumulant_function(
            p, 1e-2 / omega, omega, grid=grid)[1] is grid
        assert len(plotting.plot_cumulant_function(
            p, 1e-2 / omega, omega,
            grid_kw=dict(axes_pad=0.3, cbar_mode=None))[1]) == 3
        with pytest.raises(ValueError):
            plotting.plot_cumulant_function()
        with pytest.raises(ValueError):
            plotting.plot_cumulant_function(pulse=p)


class TestInfidelityConvergence:
    def test_lines_equal_jax_and_axes_reuse(self):
        jp, p = _both()
        grid = dict(n_min=50, n_max=100, n_points=3)
        n, infids = fft.infidelity(p, lambda w: 1e-2 / w, grid,
                                   test_convergence=True)
        jn, jinfids = ff.infidelity(jp, lambda w: 1e-2 / w, grid,
                                    test_convergence=True)
        _, axes = plotting.plot_infidelity_convergence(n, infids)
        _, jaxes = jplotting.plot_infidelity_convergence(jn, jinfids)
        for g, w in zip(axes, jaxes):
            _same_axes(g, w)
        assert plotting.plot_infidelity_convergence(n, infids,
                                                    axes=axes)[1] is axes


class TestBlochUtilities:
    def test_states_and_bloch_vectors_equal_jax(self):
        """From propagator tensors: the states and Bloch vectors are
        JAX's from the same numpy propagators; without qutip the
        trajectory plot raises."""
        theta = np.linspace(0, np.pi, 7)
        X = np.array([[0, 1], [1, 0]], complex)
        U = np.stack([np.cos(t / 2) * np.eye(2) - 1j * np.sin(t / 2) * X
                      for t in theta])
        for psi0 in (None, np.array([[0.0], [1.0]], dtype=complex)):
            states = plotting.get_states_from_prop(torch.tensor(U), psi0)
            np.testing.assert_array_equal(
                states, jplotting.get_states_from_prop(U, psi0))
            np.testing.assert_array_equal(
                plotting.get_bloch_vector(states),
                jplotting.get_bloch_vector(states))
        with pytest.raises(ValueError):
            plotting.get_states_from_prop(U, np.ones((3, 1)))
        if not plotting._HAS_QUTIP:
            with pytest.raises(RuntimeError):
                plotting.plot_bloch_vector_evolution(_both()[1])


class TestTexEscaping:
    def test_helper_equals_jax(self):
        cases = ['B%1', 'B$1', 'B#1', r'\sigma_x', r'B\%1', 'B^{(1)}',
                 'B%_#1', 'B_1', 'B%x#y&z', 'a_b$x_y$', r'B\_1']
        old = plt.rcParams['text.usetex']
        try:
            for usetex in (False, True):
                plt.rcParams['text.usetex'] = usetex
                for s in cases:
                    for math in (False, True):
                        assert plotting._make_str_tex_compatible(s, math) \
                            == jplotting._make_str_tex_compatible(s, math)
        finally:
            plt.rcParams['text.usetex'] = old

    def test_hostile_identifiers_render(self):
        from math import pi
        X, Y, Z = fft.util.paulis[1:]
        H_c = [[X / 2, [pi, 0], 'A%1'], [Y / 2, [0, pi], 'B#2']]
        H_n = [[Z / 2, [1, 1], 'C$3']]
        pulse = fft.PulseSequence(H_c, H_n, [1, 1], device='cpu')
        fig, _, legend = plotting.plot_pulse_train(pulse)
        assert sorted(t.get_text() for t in legend.get_texts()) == \
            ['$A\\%1$', '$B$#$2$']
        fig.canvas.draw()
        omega = fft.util.get_sample_frequencies(pulse, n_samples=50)
        fig, _, legend = plotting.plot_filter_function(pulse, omega)
        assert [t.get_text() for t in legend.get_texts()] == ['$C\\$3$']
        fig.canvas.draw()


@pytest.fixture()
def qutip_stub():
    """Install tests/_qutip_stub.py as `qutip` and reload both plotting
    modules so their import-time gates pick the stub up; restore
    afterwards."""
    import _qutip_stub
    old = sys.modules.get('qutip')
    sys.modules['qutip'] = _qutip_stub
    for mod in (plotting, jplotting):
        importlib.reload(mod)
    try:
        yield _qutip_stub
    finally:
        if old is None:
            del sys.modules['qutip']
        else:
            sys.modules['qutip'] = old
        for mod in (plotting, jplotting):
            importlib.reload(mod)


class TestBlochSphereWithStub:
    @staticmethod
    def _x_rotation(mod, **kw):
        from math import pi
        X, Z = mod.util.paulis[1], mod.util.paulis[3]
        return mod.PulseSequence([[X / 2, [pi, pi], 'X']],
                                 [[Z / 2, [1, 1], 'Z']], [0.5, 0.5], **kw)

    @staticmethod
    def _segments(b):
        return np.asarray([c for c in b.axes.collections
                           if hasattr(c, '_segments3d')][0]._segments3d)

    def test_qobj_branch_and_init_sphere(self, qutip_stub):
        states = [qutip_stub.Qobj([[1.0], [0.0]]),
                  qutip_stub.Qobj([[1 / np.sqrt(2)], [1 / np.sqrt(2)]])]
        np.testing.assert_array_equal(plotting.get_bloch_vector(states),
                                      jplotting.get_bloch_vector(states))
        b = plotting.init_bloch_sphere(view=[10, 20])
        assert isinstance(b, qutip_stub.Bloch) and b.view == [10, 20]

    @pytest.mark.parametrize('psi0', [None, 'down'])
    def test_trajectory_equals_jax(self, qutip_stub, psi0):
        """The trajectory's segments are JAX's within 1e-12 and on the
        closed-form great circle (1e-10)."""
        if psi0 == 'down':
            psi0 = qutip_stub.Qobj([[0.0], [1.0]])
        n = 33
        b = plotting.plot_bloch_vector_evolution(
            self._x_rotation(fft, device='cpu'), psi0=psi0, n_samples=n,
            return_Bloch=True)
        jb = jplotting.plot_bloch_vector_evolution(
            self._x_rotation(ff), psi0=psi0, n_samples=n, return_Bloch=True)
        assert b.sphere_drawn
        segs = self._segments(b)
        _close(segs, self._segments(jb))
        if psi0 is None:
            pts = np.concatenate([segs[:, 0], segs[-1:, 1]])
            t = np.linspace(0, 1, n)
            np.testing.assert_allclose(
                pts, np.stack([-np.sin(np.pi * t), np.zeros(n),
                               np.cos(np.pi * t)], axis=1), atol=1e-10)

    def test_bloch_reuse_and_cbar(self, qutip_stub):
        fig = plt.figure()
        b = qutip_stub.Bloch(fig=fig, axes=fig.add_subplot(projection='3d'))
        out = plotting.plot_bloch_vector_evolution(
            self._x_rotation(fft, device='cpu'), b=b, n_samples=20,
            add_cbar=True, show=False, return_Bloch=True)
        assert out is b and not b.sphere_drawn and len(fig.axes) == 2
        with pytest.raises(ValueError):
            plotting.plot_bloch_vector_evolution(_both(d=4)[1])
