"""The PulseSequence class of the PyTorch port (counterpart of
``filter_functions_tpu.pulse_sequence``).

Host/device split, as in the JAX package: the Hamiltonian's metadata
(operators, identifiers, coefficients, durations, the basis master
copy) lives as host numpy arrays and drives shape- and identity-level
decisions (sorting, equality, slicing).  Every computed quantity
(eigendecomposition, propagators, control matrices, filter functions)
is a tensor on the pulse's device, which the constructor takes
explicitly.  The three caches (``_data`` / ``_frequency_data`` /
``_intermediates``), their invalidation when omega changes and the
``cleanup`` tiers follow the JAX package.

``a @ b`` concatenates in time (:func:`.sequencing.concatenate`).  This
module re-exports the composition functions of :mod:`.sequencing`, as
the JAX package's does.
"""
from __future__ import annotations

import copy as _copy
from collections.abc import Mapping
from types import MappingProxyType
from typing import Optional

import numpy as np
import torch

from . import config, numeric, util
from .basis import Basis
from .superoperator import liouville_representation
from .types import Coefficients, Device, Hamiltonian

__all__ = ['PulseSequence', 'concatenate', 'concatenate_periodic', 'extend',
           'remap', 'concatenate_without_filter_function']


def _parse_hamiltonian(H, n_dt: int, H_str: str):
    """Parse the QuTiP-style nested list [[oper, coeffs, identifier?],...]
    and return (opers, identifiers, coeffs) sorted alphanumerically by
    identifier."""
    if not util.is_sequence_like(H):
        raise TypeError(f'Expected {H_str} to be a sequence, not of type '
                        f'{type(H)}!')
    # Mappings duck-type as sequences through integer keys but are not
    # valid Hamiltonian entries.
    if not all(util.is_sequence_like(item)
               and not isinstance(item, Mapping) for item in H):
        raise TypeError(f'Expected {H_str} to be a sequence of sequences '
                        'but found at least one item of H not a sequence!')

    prefix = 'A' if H_str == 'H_c' else 'B'
    opers, identifiers, coeffs = [], [], []
    for i, item in enumerate(H):
        if len(item) < 2:
            raise TypeError(f'Expected {H_str}[{i}] to contain at least an '
                            'operator and a coefficient list!')
        opers.append(item[0])
        coeffs.append(item[1])
        ident = item[2] if len(item) > 2 and item[2] is not None \
            else f'{prefix}_{i}'
        identifiers.append(ident)

    if len(set(identifiers)) != len(identifiers):
        raise ValueError(f'{H_str} identifiers should be unique')
    for coeff in coeffs:
        if not util.is_sequence_like(coeff):
            raise TypeError(f'Expected coefficients in {H_str} to be a '
                            'sequence')
        if len(coeff) != n_dt:
            raise ValueError(f'Expected all coefficients in {H_str} to be '
                             f'of len(dt) = {n_dt}!')

    opers = util.parse_operators(opers, H_str)
    identifiers = np.asarray(identifiers)
    coeffs = np.asarray([util._host(c) for c in coeffs], dtype=float)
    order = np.argsort(identifiers)
    return opers[order], identifiers[order], coeffs[order]


def _trace_axes(x: torch.Tensor, axis1: int, axis2: int) -> torch.Tensor:
    return torch.diagonal(x, 0, axis1, axis2).sum(-1)


def _join_equal_segments(pulse: 'PulseSequence'):
    """Merge consecutive segments with identical control coefficients
    before comparing pulses."""
    equal = (np.diff(pulse.c_coeffs) == 0).all(axis=0).nonzero()[0]
    if equal.size == 0:
        return pulse.c_coeffs, pulse.n_coeffs, pulse.dt
    c_coeffs = np.delete(pulse.c_coeffs, equal, axis=1)
    n_coeffs = np.delete(pulse.n_coeffs, equal, axis=1)
    dt = np.delete(pulse.dt, equal)
    for old, new in zip(equal, equal - np.arange(len(equal))):
        dt[new] += pulse.dt[old]
    return c_coeffs, n_coeffs, dt


class PulseSequence:
    r"""A control pulse defined by piecewise-constant control and noise
    Hamiltonians H_c = sum_i a_i(t) A_i, H_n = sum_a s_a(t) b_a(t) B_a.

    Parameters
    ----------
    H_c, H_n : nested lists ``[[oper, coeffs, identifier?], ...]``
    dt : segment durations, shape (n_dt,)
    basis : operator basis; defaults to the GGM basis of dimension d.
    device : where every computed quantity lives; ``'cuda'``
        (:data:`~.config.DEFAULT_DEVICE`) unless given.  Pass
        ``device='cpu'`` to run on the CPU.
    """

    def __init__(self, H_c: Hamiltonian, H_n: Hamiltonian,
                 dt: Coefficients, basis: Optional[Basis] = None,
                 device: Device = config.DEFAULT_DEVICE):
        if not util.is_sequence_like(dt):
            raise TypeError('Expected a sequence of time steps, not '
                            f'{type(dt)}')
        self.dt = util._host(dt)
        if not np.isreal(self.dt).all():
            raise ValueError('Times dt are not (all) real!')
        if (self.dt < 0).any():
            raise ValueError('Time steps are not (all) positive!')
        self.dt = self.dt.astype(float)

        self.c_opers, self.c_oper_identifiers, self.c_coeffs = \
            _parse_hamiltonian(H_c, len(self.dt), 'H_c')
        self.n_opers, self.n_oper_identifiers, self.n_coeffs = \
            _parse_hamiltonian(H_n, len(self.dt), 'H_n')

        if self.c_opers.shape[-2:] != self.n_opers.shape[-2:]:
            raise ValueError('Control and noise Hamiltonian not same '
                             'dimension!')
        self.d = self.c_opers.shape[-1]
        if basis is None:
            self.basis = Basis.ggm(self.d)
        else:
            if not isinstance(basis, Basis):
                raise ValueError("Expected basis to be an instance of the "
                                 "'filter_functions_tpu_torch.basis.Basis' "
                                 f"class, not {type(basis)}!")
            if basis.shape[1:] != (self.d, self.d):
                raise ValueError('Expected basis elements to be of shape '
                                 f'({self.d}, {self.d}), not '
                                 f'{basis.shape[1:]}!')
            self.basis = basis
        self.device = config.resolve_device(device)
        self._init_caches()

    def _init_caches(self):
        self._data = {}
        self._frequency_data = {}
        self._intermediates = {}
        self._dev = {}

    @classmethod
    def from_arrays(cls, c_opers, c_oper_identifiers, c_coeffs,
                    n_opers, n_oper_identifiers, n_coeffs, dt,
                    basis: Optional[Basis] = None,
                    device: Device = config.DEFAULT_DEVICE) -> 'PulseSequence':
        """Construct directly from arrays, taken as they are: no
        sorting, and no copy of an array that already has its dtype, so
        pulses built from the same arrays share them (concatenation
        recognizes repeated arrays by identity)."""
        new = cls.__new__(cls)
        new.c_opers = util._host(c_opers).astype(complex, copy=False)
        new.c_oper_identifiers = np.asarray(c_oper_identifiers)
        new.c_coeffs = util._host(c_coeffs).astype(float, copy=False)
        new.n_opers = util._host(n_opers).astype(complex, copy=False)
        new.n_oper_identifiers = np.asarray(n_oper_identifiers)
        new.n_coeffs = util._host(n_coeffs).astype(float, copy=False)
        new.dt = util._host(dt).astype(float, copy=False)
        new.d = new.c_opers.shape[-1]
        new.basis = basis if basis is not None else Basis.ggm(new.d)
        new.device = config.resolve_device(device)
        if not (len(new.c_opers) == len(new.c_oper_identifiers)
                == len(new.c_coeffs)):
            raise ValueError('Control Hamiltonian not same length!')
        if not (len(new.n_opers) == len(new.n_oper_identifiers)
                == len(new.n_coeffs)):
            raise ValueError('Noise Hamiltonian not same length!')
        if len(set(new.c_opers.shape[1:] + new.n_opers.shape[1:])) != 1:
            raise ValueError('Control and/or noise Hamiltonian not same, '
                             'square dimension!')
        if not (new.dt.size == new.n_coeffs.shape[1]
                == new.c_coeffs.shape[1]):
            raise ValueError('Time steps not same length!')
        if new.basis.d != new.d:
            raise ValueError('Basis dimension not same as Hamiltonian '
                             'dimension!')
        new._init_caches()
        return new

    # -- device copies ---------------------------------------------------------
    def _dev_arr(self, name: str) -> torch.Tensor:
        """Cached device copy of a host master array."""
        if name not in self._dev:
            host = getattr(self, name)
            self._dev[name] = torch.tensor(
                host, device=self.device,
                dtype=config.COMPLEX if np.iscomplexobj(host)
                else config.REAL)
        return self._dev[name]

    def _on_device(self, value) -> torch.Tensor:
        """*value* as a tensor on the pulse's device (host arrays are
        copied)."""
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.tensor(np.asarray(value), device=self.device)

    @property
    def c_opers_dev(self) -> torch.Tensor:
        return self._dev_arr('c_opers')

    @property
    def n_opers_dev(self) -> torch.Tensor:
        return self._dev_arr('n_opers')

    # -- dunder methods ---------------------------------------------------------
    def __str__(self):
        return (f'{repr(self)}\n\tof dimension {self.d} and duration '
                f'{self.duration}')

    def __len__(self) -> int:
        return len(self.dt)

    # Tell NumPy this is a scalar object: PulseSequence is iterable via
    # __getitem__, so np.asarray would otherwise unroll it into an array
    # of segment pulses.
    __array_interface__ = {'shape': (), 'typestr': '|O', 'version': 3}

    def __eq__(self, other) -> bool:
        """Physical equality: equal-segment joining, identifier-sorted
        comparison of all defining arrays, equal bases."""
        if not isinstance(other, PulseSequence):
            return NotImplemented
        atol = np.finfo(complex).eps * self.basis.shape[0]
        ca, na, dta = _join_equal_segments(self)
        cb, nb, dtb = _join_equal_segments(other)
        if len(dta) != len(dtb) or not np.allclose(dta, dtb, 1e-10, atol):
            return False
        ia_c = np.argsort(self.c_oper_identifiers)
        ib_c = np.argsort(other.c_oper_identifiers)
        ia_n = np.argsort(self.n_oper_identifiers)
        ib_n = np.argsort(other.n_oper_identifiers)
        checks = (
            (self.c_opers[ia_c], other.c_opers[ib_c]),
            (self.n_opers[ia_n], other.n_opers[ib_n]),
            (self.c_oper_identifiers[ia_c], other.c_oper_identifiers[ib_c]),
            (self.n_oper_identifiers[ia_n], other.n_oper_identifiers[ib_n]),
            (ca[ia_c], cb[ib_c]),
            (na[ia_n], nb[ib_n]),
        )
        for a, b in checks:
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                return False
        return self.basis == other.basis

    def __getitem__(self, key) -> 'PulseSequence':
        """Segment slicing; a prefix slice reuses the cached cumulative
        control matrix and second-order filter function."""
        new_dt = np.atleast_1d(self.dt[key])
        if not new_dt.size:
            raise IndexError('Cannot create empty PulseSequence')
        new = PulseSequence.from_arrays(
            c_opers=self.c_opers,
            c_oper_identifiers=self.c_oper_identifiers,
            c_coeffs=np.atleast_2d(self.c_coeffs.T[key]).T,
            n_opers=self.n_opers,
            n_oper_identifiers=self.n_oper_identifiers,
            n_coeffs=np.atleast_2d(self.n_coeffs.T[key]).T,
            dt=new_dt,
            basis=self.basis,
            device=self.device,
        )
        is_prefix = (isinstance(key, slice) and key.start in (None, 0)
                     and key.step in (None, 1) and key.stop is not None
                     and key.stop > 0)
        if is_prefix:
            cum = self._intermediates.get('control_matrix_step_cumulative')
            if cum is not None and key.stop - 1 < len(cum):
                new.cache_control_matrix(self.omega, cum[key.stop - 1])
            ff2 = self._intermediates.get('filter_function_2_step_cumulative')
            if ff2 is not None and key.stop - 1 < len(ff2):
                new.cache_filter_function(self.omega, None,
                                          ff2[key.stop - 1], order=2)
        return new

    def __copy__(self) -> 'PulseSequence':
        cls = self.__class__
        new = cls.__new__(cls)
        new.__dict__.update(self.__dict__)
        new._data = _copy.copy(self._data)
        new._frequency_data = _copy.copy(self._frequency_data)
        new._intermediates = _copy.copy(self._intermediates)
        new._dev = _copy.copy(self._dev)
        return new

    def __matmul__(self, other: 'PulseSequence') -> 'PulseSequence':
        if not isinstance(other, PulseSequence):
            raise TypeError('Incompatible type for concatenation: '
                            f'{type(other)}')
        from .sequencing import concatenate
        return concatenate((self, other))

    def __imatmul__(self, other):
        raise NotImplementedError

    # -- cache bookkeeping --------------------------------------------------------
    _DATA_ALIASES = {
        'eigenvalues': 'eigvals',
        'eigenvectors': 'eigvecs',
        'propagators': 'propagators',
        'total propagator': 'total_propagator',
        'total propagator liouville': 'total_propagator_liouville',
    }
    _FREQ_ALIASES = {
        'frequencies': 'omega',
        'total phases': 'total_phases',
        'filter function': 'filter_function',
        'fidelity filter function': 'filter_function',
        'generalized filter function': 'filter_function_gen',
        'pulse correlation filter function': 'filter_function_pc',
        'fidelity pulse correlation filter function': 'filter_function_pc',
        'generalized pulse correlation filter function':
            'filter_function_pc_gen',
        'second order filter function': 'filter_function_2',
        'control matrix': 'control_matrix',
        'pulse correlation control matrix': 'control_matrix_pc',
    }
    #: alias -> (storage dict attribute, key)
    _ALIASES = {**{a: ('_data', k) for a, k in _DATA_ALIASES.items()},
                **{a: ('_frequency_data', k)
                   for a, k in _FREQ_ALIASES.items()}}

    def is_cached(self, attr: str) -> bool:
        """Whether *attr* (a key, or a human-readable alias with spaces
        or underscores) is cached."""
        hit = self._ALIASES.get(attr.lower().replace('_', ' '))
        if hit is None:
            return (attr in self._intermediates
                    or attr in self._frequency_data
                    or attr in self._data)
        return hit[1] in getattr(self, hit[0])

    @property
    def data(self):
        return MappingProxyType(self._data)

    @property
    def frequency_data(self):
        return MappingProxyType(self._frequency_data)

    @property
    def intermediates(self):
        return MappingProxyType(self._intermediates)

    @property
    def nbytes(self) -> int:
        """Memory held by the caches, in bytes."""
        total = 0
        for val in (*self._data.values(), *self._frequency_data.values(),
                    *self._intermediates.values()):
            if isinstance(val, torch.Tensor):
                total += val.element_size() * val.nelement()
            elif hasattr(val, 'nbytes'):
                total += val.nbytes
        return total

    @util.parse_optional_parameters(
        method=('conservative', 'greedy', 'frequency dependent', 'all'))
    def cleanup(self, method: str = 'conservative') -> None:
        """Evict caches: 'conservative' the eigendecomposition and
        propagators, 'greedy' everything but the filter functions and
        the time grid, 'frequency dependent' everything that depends on
        omega, 'all' everything."""
        if method == 'all':
            self._data.clear()
            self._frequency_data.clear()
            self._intermediates.clear()
        elif method == 'frequency dependent':
            self._frequency_data.clear()
            self._intermediates.clear()
        elif method == 'greedy':
            self._intermediates.clear()
            for key in ('eigvals', 'eigvecs', 'propagators',
                        'total_propagator', 'total_propagator_liouville'):
                self._data.pop(key, None)
            for key in ('total_phases', 'control_matrix',
                        'control_matrix_pc'):
                self._frequency_data.pop(key, None)
        else:
            for key in ('eigvals', 'eigvecs', 'propagators'):
                self._data.pop(key, None)

    # -- time attributes -------------------------------------------------------
    @property
    def t(self) -> np.ndarray:
        if 't' not in self._data:
            self._data['t'] = np.concatenate(([0], self.dt.cumsum()))
        return self._data['t']

    @t.setter
    def t(self, val):
        self._data['t'] = np.asarray(val)

    @property
    def tau(self) -> float:
        if 'tau' not in self._data:
            self._data['tau'] = (float(self.t[-1]) if 't' in self._data
                                 else float(self.dt.sum()))
        return self._data['tau']

    @tau.setter
    def tau(self, val):
        self._data['tau'] = float(val)

    @property
    def duration(self) -> float:
        return self.tau

    # -- diagonalization --------------------------------------------------------
    def diagonalize(self) -> None:
        """Eigendecompose all segments and accumulate the propagators."""
        if not all(self.is_cached(a) for a in ('eigvals', 'eigvecs',
                                               'propagators')):
            (self.eigvals, self.eigvecs, self.propagators,
             self.total_propagator) = numeric.assemble_and_diagonalize(
                self.c_opers_dev, self._dev_arr('c_coeffs'),
                self._dev_arr('dt'))
        elif not self.is_cached('total_propagator'):
            self.total_propagator = self.propagators[-1]

    @property
    def eigvals(self) -> torch.Tensor:
        if not self.is_cached('eigvals'):
            self.diagonalize()
        return self._data['eigvals']

    @eigvals.setter
    def eigvals(self, value):
        self._data['eigvals'] = self._on_device(value)

    @property
    def eigvecs(self) -> torch.Tensor:
        if not self.is_cached('eigvecs'):
            self.diagonalize()
        return self._data['eigvecs']

    @eigvecs.setter
    def eigvecs(self, value):
        self._data['eigvecs'] = self._on_device(value)

    @property
    def propagators(self) -> torch.Tensor:
        if not self.is_cached('propagators'):
            self.diagonalize()
        return self._data['propagators']

    @propagators.setter
    def propagators(self, value):
        self._data['propagators'] = self._on_device(value)

    @property
    def total_propagator(self) -> torch.Tensor:
        if not self.is_cached('total_propagator'):
            self.diagonalize()
        return self._data['total_propagator']

    @total_propagator.setter
    def total_propagator(self, value):
        self._data['total_propagator'] = self._on_device(value)

    @property
    def total_propagator_liouville(self) -> torch.Tensor:
        if not self.is_cached('total_propagator_liouville'):
            self._data['total_propagator_liouville'] = \
                liouville_representation(self.total_propagator, self.basis)
        return self._data['total_propagator_liouville']

    @total_propagator_liouville.setter
    def total_propagator_liouville(self, value):
        self._data['total_propagator_liouville'] = self._on_device(value)

    # -- frequency bookkeeping ----------------------------------------------------
    @property
    def omega(self) -> Optional[torch.Tensor]:
        return self._frequency_data.get('omega', None)

    @omega.setter
    def omega(self, value):
        """Invalidates all frequency-dependent caches when the grid
        changes; the grids are compared on the pulse's device."""
        old = self._frequency_data.get('omega', None)
        new = torch.as_tensor(value, dtype=config.REAL,
                              device=self.device).clone()
        if old is None or not torch.equal(old, new):
            self.cleanup('frequency dependent')
        self._frequency_data['omega'] = new

    def get_total_phases(self, omega) -> torch.Tensor:
        """e^{i omega tau}."""
        self.omega = omega
        if not self.is_cached('total_phases'):
            self._frequency_data['total_phases'] = util.cexp(
                self.omega * self.tau)
        return self._frequency_data['total_phases']

    def cache_total_phases(self, omega, total_phases=None) -> None:
        self.omega = omega
        if total_phases is None:
            total_phases = self.get_total_phases(self.omega)
        self._frequency_data['total_phases'] = self._on_device(total_phases)

    # -- control matrix -----------------------------------------------------------
    def get_control_matrix(self, omega, show_progressbar: bool = False,
                           cache_intermediates: bool = False
                           ) -> torch.Tensor:
        """The control matrix (n_nops, n_b, n_w), cached; see
        :func:`.numeric.calculate_control_matrix_from_scratch`."""
        self.omega = omega
        if self.is_cached('control_matrix'):
            return self._frequency_data['control_matrix']
        if self.is_cached('control_matrix_pc'):
            self._frequency_data['control_matrix'] = \
                self._frequency_data['control_matrix_pc'].sum(0)
            return self._frequency_data['control_matrix']

        self.diagonalize()
        result = numeric.calculate_control_matrix_from_scratch(
            self.eigvals, self.eigvecs, self.propagators, self.omega,
            self.basis, self.n_opers_dev, self.n_coeffs, self.dt, t=self.t,
            show_progressbar=show_progressbar,
            cache_intermediates=cache_intermediates)
        if cache_intermediates:
            control_matrix, intermediates = result
            self._intermediates.update(intermediates)
        else:
            control_matrix = result
        self.cache_control_matrix(self.omega, control_matrix)
        return self._frequency_data['control_matrix']

    def cache_control_matrix(self, omega, control_matrix=None,
                             show_progressbar: bool = False,
                             cache_intermediates: bool = False) -> None:
        """Cache a control matrix (computed if not given; a 4-d one is the
        pulse-correlation control matrix) with the total phases and the
        total propagator's Liouville representation."""
        self.omega = omega
        if control_matrix is None:
            control_matrix = self.get_control_matrix(
                self.omega, show_progressbar, cache_intermediates)
        control_matrix = self._on_device(control_matrix)
        if control_matrix.ndim == 4:
            self._frequency_data['control_matrix_pc'] = control_matrix
        else:
            self._frequency_data['control_matrix'] = control_matrix
        self.cache_total_phases(self.omega)
        if not self.is_cached('total_propagator_liouville'):
            self.total_propagator_liouville = liouville_representation(
                self.total_propagator, self.basis)

    def get_pulse_correlation_control_matrix(self) -> torch.Tensor:
        if self.is_cached('control_matrix_pc'):
            return self._frequency_data['control_matrix_pc']
        raise util.CalculationError(
            "Could not get the pulse correlation control matrix since it "
            "was not computed during concatenation. Please run the "
            "concatenation again with 'calc_pulse_correlation_FF' set to "
            "True.")

    # -- filter functions ----------------------------------------------------------
    @util.parse_optional_parameters(which=('fidelity', 'generalized'),
                                    order=(1, 2))
    def get_filter_function(self, omega, which: str = 'fidelity',
                            order: int = 1,
                            show_progressbar: bool = False,
                            cache_intermediates: bool = False,
                            cache_second_order_cumulative: bool = False
                            ) -> torch.Tensor:
        """The filter function, cached.  First order: (n_nops, n_nops,
        n_w) 'fidelity' or (n_nops, n_nops, n_b, n_b, n_w)
        'generalized'; second order: F^(2) (n_nops, n_nops, n_b, n_b,
        n_w), see :func:`.numeric.
        calculate_second_order_filter_function_from_scratch`."""
        self.omega = omega
        if order == 1:
            key = 'filter_function' if which == 'fidelity' \
                else 'filter_function_gen'
        else:
            key = 'filter_function_2'
        if self.is_cached(key):
            return self._frequency_data[key]
        control_matrix = None
        if order == 1:
            control_matrix = self.get_control_matrix(
                self.omega, show_progressbar, cache_intermediates)
        self.cache_filter_function(
            self.omega, control_matrix=control_matrix, which=which,
            order=order, show_progressbar=show_progressbar,
            cache_intermediates=cache_intermediates,
            cache_second_order_cumulative=cache_second_order_cumulative)
        return self._frequency_data[key]

    @util.parse_optional_parameters(which=('fidelity', 'generalized'),
                                    order=(1, 2))
    def cache_filter_function(self, omega, control_matrix=None,
                              filter_function=None, which: str = 'fidelity',
                              order: int = 1,
                              show_progressbar: bool = False,
                              cache_intermediates: bool = False,
                              cache_second_order_cumulative: bool = False
                              ) -> None:
        """Cache the filter function, given or computed.  At first order
        it comes from the control matrix, and a 4-d control matrix also
        caches the pulse-correlation filter function; at second order
        from scratch, reusing the cached first-order intermediates,
        and with ``cache_intermediates`` caching its own (with
        ``cache_second_order_cumulative`` the F^(2) of every prefix,
        which slicing reuses)."""
        self.omega = omega
        if filter_function is None and order == 1:
            if control_matrix is None:
                control_matrix = self.get_control_matrix(
                    self.omega, show_progressbar, cache_intermediates)
            self.cache_control_matrix(self.omega, control_matrix)
            control_matrix = self._on_device(control_matrix)
            if control_matrix.ndim == 4:
                f_pc = numeric.calculate_pulse_correlation_filter_function(
                    control_matrix, which)
                if which == 'fidelity':
                    self._frequency_data['filter_function_pc'] = f_pc
                else:
                    self._frequency_data['filter_function_pc'] = \
                        _trace_axes(f_pc, 4, 5)
                    self._frequency_data['filter_function_pc_gen'] = f_pc
                filter_function = f_pc.sum(0).sum(0)
            else:
                filter_function = numeric.calculate_filter_function(
                    control_matrix, which)
        elif filter_function is None:
            self.diagonalize()
            result = numeric.\
                calculate_second_order_filter_function_from_scratch(
                    self.eigvals, self.eigvecs, self.propagators,
                    self.omega, self.basis, self.n_opers_dev, self.n_coeffs,
                    self.dt, intermediates=dict(self._intermediates),
                    show_progressbar=show_progressbar,
                    cache_intermediates=cache_intermediates,
                    cache_cumulative=cache_second_order_cumulative)
            if cache_intermediates:
                filter_function, intermediates = result
                self._intermediates.update(intermediates)
            else:
                filter_function = result
        filter_function = self._on_device(filter_function)

        if order == 2:
            self._frequency_data['filter_function_2'] = filter_function
        elif which == 'fidelity':
            self._frequency_data['filter_function'] = filter_function
        else:
            self._frequency_data['filter_function'] = \
                _trace_axes(filter_function, 2, 3)
            self._frequency_data['filter_function_gen'] = filter_function

    @util.parse_optional_parameters(which=('fidelity', 'generalized'))
    def get_pulse_correlation_filter_function(self, which: str = 'fidelity'
                                              ) -> torch.Tensor:
        """The pulse-correlation filter function; it exists only for a
        pulse whose pulse-correlation control matrix is cached."""
        key = ('filter_function_pc' if which == 'fidelity'
               else 'filter_function_pc_gen')
        if self.is_cached(key):
            return self._frequency_data[key]
        if self.is_cached('control_matrix_pc'):
            f_pc = numeric.calculate_pulse_correlation_filter_function(
                self._frequency_data['control_matrix_pc'], which=which)
            self._frequency_data[key] = f_pc
            return f_pc
        raise util.CalculationError(
            "Could not get the pulse correlation filter function since it "
            "was not computed during concatenation. Please run the "
            "concatenation again with 'calc_pulse_correlation_FF' set to "
            "True.")

    def get_filter_function_derivative(self, omega, control_identifiers=None,
                                       n_oper_identifiers=None,
                                       n_coeffs_deriv=None) -> torch.Tensor:
        """The analytic derivative dF_a(w)/du_h(t_g) of the fidelity
        filter function w.r.t. the control amplitudes, (n_nops, n_dt,
        n_ctrl, n_w) float64 for the selected noise and control
        operators (identifier order); see
        :func:`.gradient.calculate_derivative_of_control_matrix_from_scratch`.
        *n_coeffs_deriv* (n_nops, n_ctrl, n_dt), in the order of the
        selected identifiers, adds the dependence of the noise
        sensitivities on the control amplitudes."""
        from . import gradient
        c_idx = util.get_indices_from_identifiers(self.c_oper_identifiers,
                                                  control_identifiers)
        n_idx = util.get_indices_from_identifiers(self.n_oper_identifiers,
                                                  n_oper_identifiers)
        if n_coeffs_deriv is not None:
            required = (len(n_idx), len(c_idx), len(self))
            actual = np.shape(n_coeffs_deriv)
            if actual != required:
                raise ValueError('Expected n_coeffs_deriv to be of shape '
                                 f'{required}, not {actual}. Did you forget '
                                 'to specify identifiers?')
        self.omega = omega
        n_idx_dev = torch.as_tensor(n_idx, device=self.device)
        intermediates = {}
        n_t = self._intermediates.get('n_opers_transformed')
        if n_t is not None:
            intermediates['n_opers_transformed'] = n_t[n_idx_dev]
        integral = self._intermediates.get('first_order_integral')
        if integral is not None:
            intermediates['first_order_integral'] = integral

        control_matrix = self.get_control_matrix(
            self.omega, cache_intermediates=True)[n_idx_dev]
        control_matrix_deriv = \
            gradient.calculate_derivative_of_control_matrix_from_scratch(
                self.omega, self.propagators, self.eigvals, self.eigvecs,
                self.basis, self.t, self.dt, self.n_opers_dev[n_idx_dev],
                self.n_coeffs[n_idx],
                self.c_opers_dev[torch.as_tensor(c_idx, device=self.device)],
                n_coeffs_deriv, intermediates)
        return gradient.calculate_filter_function_derivative(
            control_matrix, control_matrix_deriv)

    def propagator_at_arb_t(self, t) -> torch.Tensor:
        """Propagators Q(t) (n_t, d, d) at arbitrary times, exact for the
        piecewise-constant Hamiltonian."""
        self.diagonalize()
        t = util._host(t)
        idx = np.clip(np.searchsorted(self.t, t) - 1, 0, len(self.dt) - 1)
        idx_t = torch.as_tensor(idx, device=self.device)
        eigvecs = self.eigvecs[idx_t]
        phases = util.cexp(self._on_device(self.t[idx] - t)[:, None]
                               * self.eigvals[idx_t])
        u_curr = (eigvecs * phases[:, None, :]) @ eigvecs.mH
        return u_curr @ self.propagators[idx_t]


# The sequencing API, defined in .sequencing; imported last because that
# module imports this one.
from .sequencing import (concatenate, concatenate_periodic,  # noqa: E402
                         concatenate_without_filter_function, extend, remap)
