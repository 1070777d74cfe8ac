"""Plotting of the PyTorch port (counterpart of
``filter_functions_tpu.plotting``).

All plotting is host-side matplotlib; device tensors are copied to the
host at the boundary (``.cpu().numpy()``).  The module needs matplotlib
and raises ImportError without it; the package does not import it.  The
Bloch-sphere trajectory plot needs qutip and raises RuntimeError without
it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import numeric, util

try:
    import matplotlib.pyplot as plt
    from matplotlib import collections as mcollections
    from matplotlib import colors
except ImportError as err:
    raise ImportError('matplotlib is required for the plotting module: '
                      f'{err}') from err

try:
    import qutip as qt
    _HAS_QUTIP = True
except ImportError:
    qt = None
    _HAS_QUTIP = False

__all__ = ['plot_filter_function', 'plot_pulse_train',
           'plot_pulse_correlation_filter_function',
           'plot_cumulant_function', 'plot_infidelity_convergence',
           'plot_bloch_vector_evolution', 'get_bloch_vector',
           'get_states_from_prop', 'init_bloch_sphere']


def _np(x) -> np.ndarray:
    """Device tensors (and anything array-like) as host numpy arrays."""
    return util._host(x)


def _make_str_tex_compatible(s, math: bool = False) -> str:
    """Escape characters in user-supplied identifiers/labels that break
    TeX or mathtext rendering.

    Under ``text.usetex`` the TeX specials are escaped; under
    matplotlib's default *mathtext* renderer, where
    ``%``/``#`` raise ParseException and a stray ``$`` unbalances the
    surrounding math environment.  With ``math=True`` the string is
    destined for a ``$...$`` wrapper; intentional TeX (``\\sigma_x``,
    ``B^{(1)}``, already-escaped specials) is left untouched.
    """
    s = str(s)
    usetex = plt.rcParams['text.usetex']
    if not usetex and not math:
        return s  # plain mathtext text renders any character

    # usetex supports embedded $math$ environments, so '$' stays;
    # mathtext math-mode labels get '$' escaped since a
    # stray one unbalances the surrounding wrapper.
    specials = '_%#&' if usetex else '%$#'
    out = []
    for loc, ch in enumerate(s):
        if ch in specials and not s[loc - 1:loc] == '\\':
            if ch == '_' and s.count('$', loc) % 2:
                out.append(ch)  # inside an embedded math environment
            elif ch == '#' and not usetex:
                # mathtext has no \# escape; emit as literal text by
                # interrupting the surrounding math environment
                out.append('$#$')
            else:
                out.append('\\' + ch)
        else:
            out.append(ch)
    return ''.join(out)


def get_states_from_prop(U, psi0=None) -> np.ndarray:
    """|psi(t)> = U(t, 0)|psi(0)> for a stack of propagators (tensors
    are copied to the host)."""
    if psi0 is None:
        psi0 = np.array([[1.], [0.]], dtype=complex)
    elif hasattr(psi0, 'full'):   # qutip.Qobj
        psi0 = psi0.full()
    psi0 = np.asarray(psi0)
    if psi0.shape[-2:] != (2, 1):
        raise ValueError('Initial state should be shape (..., 2, 1)')
    return _np(U) @ psi0


def get_bloch_vector(states) -> np.ndarray:
    """Bloch vector components (<X>, <Y>, <Z>) of a sequence of
    single-qubit states."""
    if _HAS_QUTIP and isinstance(states[0], qt.Qobj):
        states = np.stack([s.full() for s in states])
    states = _np(states).astype(complex).reshape(-1, 2, 1)
    a, c = states[:, 0, 0], states[:, 1, 0]
    return np.stack([2 * (a.conj() * c).real,
                     2 * (a.conj() * c).imag,
                     (np.abs(a)**2 - np.abs(c)**2)])


def init_bloch_sphere(**bloch_kwargs):
    """qutip Bloch sphere with default view and axis labels (requires
    qutip)."""
    if not _HAS_QUTIP:
        raise RuntimeError('Requires qutip.')
    bloch_kwargs.setdefault('view', [-150, 30])
    b = qt.Bloch(**bloch_kwargs)
    if hasattr(b.axes, 'set_box_aspect'):
        b.axes.set_box_aspect([1, 1, 1])
    b.xlabel = [r'$|+\rangle$', '']
    b.ylabel = [r'$|+_i\rangle$', '']
    return b


def _import_or_axes(fig=None, axes=None, figsize=None):
    if axes is not None:
        return axes.get_figure(), axes
    if fig is not None:
        return fig, fig.add_subplot(111)
    return plt.subplots(figsize=figsize)


def plot_pulse_train(pulse, c_oper_identifiers: Optional[Sequence] = None,
                     fig=None, axes=None, cycler=None, plot_kw=None,
                     subplot_kw=None, gridspec_kw=None, **figure_kw):
    """Plot the control coefficients as a piecewise-constant train."""
    c_idx = util.get_indices_from_identifiers(pulse.c_oper_identifiers,
                                              c_oper_identifiers)
    fig, axes = _import_or_axes(fig, axes)
    if cycler is not None:
        axes.set_prop_cycle(cycler)
    t = np.asarray(pulse.t)
    handles = []
    for i in c_idx:
        coeffs = np.asarray(pulse.c_coeffs[i])
        label = _make_str_tex_compatible(pulse.c_oper_identifiers[i],
                                         math=True)
        handles += axes.step(t, np.concatenate([coeffs[:1], coeffs]),
                             label=f'${label}$', **(plot_kw or {}))
    axes.set_xlim(t[0], t[-1])
    axes.set_xlabel('$t$ / a.u.')
    axes.set_ylabel('Control parameter / a.u.')
    legend = axes.legend(framealpha=1)
    return fig, axes, legend


def plot_filter_function(pulse, omega: Optional[np.ndarray] = None,
                         n_oper_identifiers: Optional[Sequence] = None,
                         fig=None, axes=None, xscale: str = 'log',
                         yscale: str = 'linear', omega_in_units_of_tau:
                         bool = True, cycler=None, plot_kw=None,
                         subplot_kw=None, gridspec_kw=None, **figure_kw):
    """Plot the fidelity filter function(s) of *pulse* (computed on its
    device, plotted on the host)."""
    if omega is None:
        if pulse.is_cached('omega'):
            omega = pulse.omega
        else:
            omega = util.get_sample_frequencies(pulse, spacing=xscale)
    n_idx = util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                              n_oper_identifiers)
    ff_ = _np(pulse.get_filter_function(omega)).real

    fig, axes = _import_or_axes(fig, axes)
    if cycler is not None:
        axes.set_prop_cycle(cycler)
    if omega_in_units_of_tau:
        x = _np(omega) * pulse.tau
        xlabel = r'$\omega\tau$'
    else:
        x = _np(omega)
        xlabel = r'$\omega$'
    handles = []
    for i in n_idx:
        label = _make_str_tex_compatible(pulse.n_oper_identifiers[i],
                                         math=True)
        handles += axes.plot(x, ff_[i, i], label=f'${label}$',
                             **(plot_kw or {}))
    axes.set_xscale(xscale)
    if yscale == 'log':
        axes.set_yscale('log')
    axes.set_xlim(x[x > 0].min() if xscale == 'log' else x.min(), x.max())
    axes.set_xlabel(xlabel)
    axes.set_ylabel(r'$F(\omega)$')
    legend = axes.legend(framealpha=1)
    return fig, axes, legend


def plot_pulse_correlation_filter_function(
        pulse, n_oper_identifiers: Optional[Sequence] = None, fig=None,
        xscale: str = 'log', yscale: str = 'linear',
        omega_in_units_of_tau: bool = True, cycler=None, plot_kw=None,
        subplot_kw=None, gridspec_kw=None, **figure_kw):
    """Plot the pulse correlation filter functions F^(gg') as a G x G
    grid of axes."""
    f_pc = _np(pulse.get_pulse_correlation_filter_function()).real
    omega = _np(pulse.omega)
    n_idx = util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                              n_oper_identifiers)
    n_pls = f_pc.shape[0]
    if fig is None:
        fig, axes = plt.subplots(n_pls, n_pls, sharex=True, sharey=True,
                                 subplot_kw=subplot_kw,
                                 gridspec_kw=gridspec_kw, **figure_kw)
    else:
        axes = np.array(fig.axes).reshape(n_pls, n_pls)
    axes = np.atleast_2d(axes)
    x = omega * pulse.tau if omega_in_units_of_tau else omega
    xlabel = r'$\omega\tau$' if omega_in_units_of_tau else r'$\omega$'
    for g in range(n_pls):
        for h in range(n_pls):
            ax = axes[g, h]
            if cycler is not None:
                ax.set_prop_cycle(cycler)
            for i in n_idx:
                label = _make_str_tex_compatible(
                    pulse.n_oper_identifiers[i], math=True)
                ax.plot(x, f_pc[g, h, i, i], label=f'${label}$',
                        **(plot_kw or {}))
            ax.set_xscale(xscale)
            if yscale == 'log':
                ax.set_yscale('log')
            ax.set_title(f'$F^{{({g}{h})}}$')
            if g == n_pls - 1:
                ax.set_xlabel(xlabel)
    legend = axes[0, 0].legend(framealpha=1)
    return fig, axes, legend


def plot_infidelity_convergence(n_samples, infids, axes=None):
    """Plot the convergence test output of :func:`~.numeric.infidelity`."""
    if axes is None:
        fig, axes = plt.subplots(2, 1, sharex=True)
    else:
        fig = axes[0].get_figure()
    n_samples = _np(n_samples)
    infids = np.atleast_2d(_np(infids))
    axes[0].plot(n_samples, infids, 'o-')
    axes[0].set_ylabel(r'$\mathcal{I}$')
    rel_diff = np.abs(1 - infids[1:] / infids[:-1]).sum(axis=1)
    axes[1].plot(n_samples[1:], rel_diff, 'o-')
    axes[1].set_xlabel(r'$n_\omega$')
    axes[1].set_ylabel(r'$|1 - \mathcal{I}_n / \mathcal{I}_{n-1}|$')
    return fig, axes


def plot_cumulant_function(
        pulse=None, spectrum=None, omega=None, cumulant_function=None,
        n_oper_identifiers: Optional[Sequence] = None,
        second_order: bool = False, colorscale: str = 'linear',
        linthresh: Optional[float] = None, basis_labels=None,
        basis_labelsize=None, cmap=None, fig=None, grid=None, cbar_label:
        str = 'Cumulant Function', cbar_labelsize=None, subplot_kw=None,
        gridspec_kw=None, grid_kw=None, cbar_kw=None, imshow_kw=None,
        **figure_kw):
    """Image-plot the cumulant function matrices K_{a,ij}."""
    if cumulant_function is None:
        if pulse is None or spectrum is None or omega is None:
            raise ValueError('Require either precomputed cumulant function '
                             'or pulse, spectrum, and omega as arguments.')
        cumulant_function = numeric.calculate_cumulant_function(
            pulse, spectrum, omega, n_oper_identifiers,
            second_order=second_order)
        labels = list(pulse.n_oper_identifiers
                      if n_oper_identifiers is None else n_oper_identifiers)
        if basis_labels is None:
            basis_labels = pulse.basis.labels
    else:
        labels = [str(i) for i in range(_np(cumulant_function).shape[0])]

    k = _np(cumulant_function)
    if k.ndim == 2:
        k = k[None]
    n_panels = k.shape[0]
    if grid is None:
        if grid_kw:
            from mpl_toolkits.axes_grid1 import ImageGrid
            fig = plt.figure(**figure_kw)
            grid = np.asarray(ImageGrid(fig, 111,
                                        nrows_ncols=(1, n_panels),
                                        **grid_kw))
        else:
            fig, grid = plt.subplots(1, n_panels, squeeze=False,
                                     subplot_kw=subplot_kw,
                                     gridspec_kw=gridspec_kw, **figure_kw)
            grid = grid[0]
    else:
        fig = grid[0].get_figure()

    kmax = np.abs(k).max()
    if colorscale == 'log':
        norm = colors.SymLogNorm(
            linthresh=linthresh or kmax * 1e-6, vmin=-kmax, vmax=kmax)
    else:
        norm = colors.Normalize(vmin=-kmax, vmax=kmax)

    for panel, (ax, ki) in enumerate(zip(grid, k)):
        im = ax.imshow(ki, norm=norm, cmap=cmap or 'RdBu',
                       **(imshow_kw or {}))
        label = _make_str_tex_compatible(labels[panel], math=True) \
            if panel < len(labels) else None
        ax.set_title(f'$K({label})$' if label is not None else '')
        if basis_labels is not None:
            tick_labels = [_make_str_tex_compatible(lab)
                           for lab in basis_labels]
            ax.set_xticks(range(len(tick_labels)))
            ax.set_yticks(range(len(tick_labels)))
            ax.set_xticklabels(tick_labels, rotation=90,
                               fontsize=basis_labelsize)
            ax.set_yticklabels(tick_labels, fontsize=basis_labelsize)
    cbar = fig.colorbar(im, ax=list(grid), label=cbar_label,
                        **(cbar_kw or {}))
    if cbar_labelsize is not None:
        cbar.set_label(cbar_label, size=cbar_labelsize)
    return fig, grid


def plot_bloch_vector_evolution(pulse, psi0=None, b=None, n_samples=None,
                                cmap='winter', add_cbar: bool = False,
                                show: bool = True, return_Bloch:
                                bool = False, cbar_kwargs=None, **bloch_kw):
    """Plot the Bloch-vector trajectory of a qubit state under *pulse*
    as a single time-colored 3d line collection (requires qutip)."""
    if not _HAS_QUTIP:
        raise RuntimeError('Requires qutip.')
    if pulse.d != 2:
        raise ValueError('Plotting Bloch vector evolution only implemented '
                         'for single-qubit pulses!')
    figsize = bloch_kw.pop('figsize', (5, 5))
    view = bloch_kw.pop('view', [-60, 30])
    if b is None:
        fig = plt.figure(figsize=figsize)
        axes = fig.add_subplot(projection='3d', azim=view[0],
                               elev=view[1])
        b = init_bloch_sphere(fig=fig, axes=axes, **bloch_kw)
    else:
        if b.fig is None:
            b.fig = plt.figure(figsize=figsize)
        if b.axes is None:
            b.axes = b.fig.add_subplot(projection='3d', azim=view[0],
                                       elev=view[1])
    if show:
        # the sphere must exist before the line collection is added,
        # else make_sphere() would clear it again
        b.make_sphere()

    if n_samples is None:
        n_samples = min(5000, max(
            10 * int(pulse.tau / pulse.dt.min()), 100))
    t = np.linspace(0, float(pulse.tau), n_samples)
    propagators = _np(pulse.propagator_at_arb_t(t))
    vectors = get_bloch_vector(get_states_from_prop(propagators, psi0))
    # qutip sphere convention: -x at +y, +y at +x
    vectors = np.stack([vectors[1], -vectors[0], vectors[2]])

    points = vectors.T.reshape(-1, 1, 3)
    segments = np.concatenate([points[:-1], points[1:]], axis=1)
    cmap_obj = plt.get_cmap(cmap) if isinstance(cmap, str) else cmap
    lc = mcollections.LineCollection(
        segments[:, :, :2], colors=cmap_obj(np.linspace(0, 1,
                                                        n_samples - 1)),
        alpha=0.75)
    b.axes.add_collection3d(lc, zdir='z', zs=segments[:, :, 2])

    if add_cbar:
        kw = dict(shrink=2 / 3, pad=0.05, label=r'$t$ ($\tau$)',
                  ticks=[0, 1], ax=b.axes)
        kw.update(cbar_kwargs or {})
        b.fig.colorbar(plt.cm.ScalarMappable(
            norm=colors.Normalize(0, 1), cmap=cmap_obj), **kw)
    if return_Bloch:
        return b
