"""Pulse composition (counterpart of ``filter_functions_tpu.sequencing``):
in time, :func:`concatenate`, :func:`concatenate_periodic` and
:func:`concatenate_without_filter_function`; in space, :func:`remap`
(permute the qubits of a pulse) and :func:`extend` (map pulses onto a
larger register).

The identifier and hash bookkeeping is host-side string and index
logic on numpy arrays; it decides which cached control matrices are
reused.  The array math (boundary phases, cumulative propagators, the
sum over atomic control matrices, the closed-form periodic series) runs
on the pulses' device through :mod:`.numeric`.  ``remap`` and ``extend``
carry the cached eigendecompositions, propagators and control matrices
over by tensor-product index arithmetic on the device.

Long trains repeat few pulse objects.  All bookkeeping is therefore done
once per distinct object (keyed by ``id``), and the per-position stacks
the device math needs are one ``torch.stack`` of the distinct tensors
gathered by one index.
"""
from __future__ import annotations

import bisect
import copy as _copy
import math
from itertools import accumulate
from typing import Dict, Iterable, List, Mapping, Optional, Sequence
from warnings import warn

import numpy as np
import torch

from . import config, numeric, util
from .basis import (Basis, equivalent_pauli_basis_elements,
                    remap_pauli_basis_elements)
from .pulse_sequence import PulseSequence, _parse_hamiltonian
from .types import Coefficients, Hamiltonian, PulseMapping

__all__ = ['concatenate', 'concatenate_periodic',
           'concatenate_without_filter_function', 'extend', 'remap']


# -----------------------------------------------------------------------------
# Hamiltonian union (host-side metadata algebra)
# -----------------------------------------------------------------------------
def _infer_missing_coeffs(coeffs: np.ndarray, kind: str) -> None:
    """Fill, in place, the NaN entries of a merged coefficient grid:
    zeros for control operators; for noise operators the operator's one
    constant sensitivity, an error where it is not constant."""
    nan_mask = np.isnan(coeffs)
    if kind != 'noise':
        coeffs[nan_mask] = 0
        return
    for row in nan_mask.any(axis=1).nonzero()[0]:
        known = coeffs[row][~nan_mask[row]]
        if not (known == known[0]).all():
            raise ValueError('Not all pulses have the same noise operators '
                             'and non-trivial noise sensitivities so I '
                             'cannot infer them.')
        coeffs[row, nan_mask[row]] = known[0]


def _concatenate_hamiltonian(opers, identifiers, coeffs, kind: str):
    """Union the operators of several pulses by array hash, resolve
    identifier clashes, and lay the coefficients into the concatenated
    segment grid.

    The same operator under different identifiers is an error; the same
    identifier for different operators gets the suffix ``_p`` with the
    position of the first pulse that carries each; missing noise
    sensitivities are inferred where constant, else an error.

    Returns (operators, identifiers, coefficients, mapping), sorted by
    identifier; ``mapping[p]`` maps pulse p's identifiers to the merged
    ones (pulses that share operator and identifier arrays share one
    dict).
    """
    if len(opers) > 1:
        if all(o is opers[0] and i is identifiers[0]
               for o, i in zip(opers, identifiers)):
            # a train of one repeated pulse object: operators and
            # identifiers pass through (rows are already sorted), the
            # coefficient grid is one tile
            idents = [str(s) for s in identifiers[0]]
            if all(c is coeffs[0] for c in coeffs):
                concat_coeffs = np.tile(np.asarray(coeffs[0]),
                                        (1, len(coeffs)))
            else:
                concat_coeffs = np.concatenate(
                    [np.asarray(c) for c in coeffs], axis=1)
            shared = {i: i for i in idents}
            return (np.asarray(opers[0]), np.array(idents), concat_coeffs,
                    {p: shared for p in range(len(opers))})

    if len(opers) > 64:
        # few distinct pulses (random or Clifford trains of cached
        # pulses): union the distinct (opers, identifiers, coeffs)
        # triples and expand the coefficient grid by one gather.  The
        # general path below walks every pulse in Python.  Distinct
        # pulses may differ in segment count.  Falls through when an
        # identifier is renamed: the suffix depends on the whole train.
        keyed: Dict[tuple, int] = {}
        didx = np.empty(len(opers), np.int64)
        d_op, d_id, d_co = [], [], []
        for g in range(len(opers)):
            key = (id(opers[g]), id(identifiers[g]), id(coeffs[g]))
            j = keyed.get(key)
            if j is None:
                j = keyed[key] = len(d_op)
                d_op.append(opers[g])
                d_id.append(identifiers[g])
                d_co.append(coeffs[g])
            didx[g] = j
        n_k = len(d_op)
        if n_k <= len(opers) // 4:
            c_opers, c_idents, _, map_d = _concatenate_hamiltonian(
                d_op, d_id, d_co, kind)
            if all(k == v for m in map_d.values() for k, v in m.items()):
                row_of = {ident: r for r, ident in enumerate(c_idents)}
                widths = np.array([np.asarray(c).shape[1] for c in d_co])
                # per-distinct coefficient tiles in the merged row order
                # (NaN where a pulse lacks the operator), side by side
                # at the offsets off[k]
                cat = np.full((len(c_idents), int(widths.sum())), np.nan)
                off = np.concatenate([[0], np.cumsum(widths)[:-1]])
                for k in range(n_k):
                    rows = [row_of[map_d[k][str(i)]] for i in d_id[k]]
                    cat[rows, off[k]:off[k] + widths[k]] = \
                        np.asarray(d_co[k])
                _infer_missing_coeffs(cat, kind)
                # column j of position g reads cat[:, off[didx[g]] + j]
                w_train = widths[didx]
                seg0 = np.concatenate([[0], np.cumsum(w_train)[:-1]])
                within = np.arange(int(w_train.sum())) \
                    - np.repeat(seg0, w_train)
                concat_coeffs = cat[:, np.repeat(off[didx], w_train) + within]
                mapping = {p: map_d[int(didx[p])]
                           for p in range(len(opers))}
                return c_opers, c_idents, concat_coeffs, mapping

    n_dt_per_pulse = [c.shape[1] for c in coeffs]
    seg_bounds = [0] + list(accumulate(n_dt_per_pulse))
    n_ops_per_pulse = [len(op) for op in opers]
    pulse_bounds = list(accumulate(n_ops_per_pulse))
    pulse_starts = [0] + pulse_bounds

    # hash every distinct operator-array object once
    hash_memo: Dict[int, List[int]] = {}
    per_pulse_hashes = []
    for op in opers:
        h = hash_memo.get(id(op))
        if h is None:
            h = hash_memo[id(op)] = util.hash_array_along_axis(op, axis=0)
        per_pulse_hashes.append(h)
    oper_hashes = [h for hs in per_pulse_hashes for h in hs]
    uniq_hashes, first_idx, inverse = np.unique(
        oper_hashes, return_index=True, return_inverse=True)
    uniq_hashes = uniq_hashes.tolist()

    def locate(flat):
        """(pulse, row within the pulse) of a flat operator index."""
        p = bisect.bisect(pulse_bounds, int(flat))
        return p, int(flat) - pulse_starts[p]

    def ident_at(flat):
        p, row = locate(flat)
        return str(identifiers[p][row])

    uniq_identifiers = [ident_at(fp) for fp in first_idx]
    uniq_opers = np.array([np.asarray(opers[p])[row]
                           for p, row in map(locate, first_idx)])

    # hash tables in both directions to detect clashes, once per
    # distinct pair of operator and identifier arrays
    oper_to_ids: Dict[int, set] = {}
    id_to_opers: Dict[str, set] = {}
    seen_pairs: set = set()
    for p, (op, idents) in enumerate(zip(opers, identifiers)):
        key = (id(op), id(idents))
        if key in seen_pairs:
            continue
        seen_pairs.add(key)
        for h, ident in zip(per_pulse_hashes[p], idents):
            oper_to_ids.setdefault(h, set()).add(ident)
            id_to_opers.setdefault(ident, set()).add(h)

    if any(len(ids) > 1 for ids in oper_to_ids.values()):
        raise ValueError(f'Trying to concatenate pulses with equal {kind} '
                         'operators but different identifiers. Please '
                         f'choose unique {kind} identifiers!')

    # identifier -> identifier maps, one dict per distinct pair of
    # operator and identifier arrays.  Sharing is safe: a rename below
    # changes every pulse that carries the same (identifier, operator)
    # pair in the same way.
    shared_maps: Dict[tuple, dict] = {}
    mapping = {}
    for p in range(len(opers)):
        key = (id(opers[p]), id(identifiers[p]))
        m = shared_maps.get(key)
        if m is None:
            m = shared_maps[key] = {str(ident): str(ident)
                                    for ident in identifiers[p]}
        mapping[p] = m
    hashes_arr = np.asarray(oper_hashes)
    for ident, hashes in id_to_opers.items():
        if len(hashes) > 1:
            # one identifier for different operators: disambiguate by
            # the position of the first pulse that carries each operator
            for h in hashes:
                pulse_pos, _ = locate(oper_hashes.index(h))
                uniq_pos = uniq_hashes.index(h)
                new_ident = f'{uniq_identifiers[uniq_pos]}_{pulse_pos}'
                uniq_identifiers[uniq_pos] = new_ident
                # every pulse that carries this pair, not only the first
                for fp in (hashes_arr == h).nonzero()[0]:
                    if ident_at(fp) == ident:
                        mapping[locate(fp)[0]][ident] = new_ident

    sort_idx = np.argsort(uniq_identifiers)
    concat_opers = uniq_opers[sort_idx]
    concat_identifiers = np.array([uniq_identifiers[i] for i in sort_idx])

    concat_coeffs = np.full((len(uniq_identifiers), seg_bounds[-1]), np.nan)
    start = 0
    for p, pulse_coeffs in enumerate(coeffs):
        rows = inverse[start:start + n_ops_per_pulse[p]]
        concat_coeffs[rows, seg_bounds[p]:seg_bounds[p + 1]] = pulse_coeffs
        start += n_ops_per_pulse[p]
    _infer_missing_coeffs(concat_coeffs, kind)
    return concat_opers, concat_identifiers, concat_coeffs[sort_idx], mapping


def _distinct(pulses: Sequence[PulseSequence]) -> Dict[int, PulseSequence]:
    """The distinct pulse objects of a train by ``id``, checked to be
    pulses on one device."""
    uniq = {id(p): p for p in pulses}
    if not all(isinstance(p, PulseSequence) for p in uniq.values()):
        raise TypeError('Can only concatenate PulseSequences!')
    if len({p.device for p in uniq.values()}) != 1:
        raise ValueError('Trying to concatenate PulseSequence instances on '
                         'different devices!')
    return uniq


def concatenate_without_filter_function(
        pulses: Iterable[PulseSequence],
        return_identifier_mappings: bool = False):
    """Concatenate pulses in time, merging their Hamiltonians, without
    any filter-function work.  The new pulse lives on the device of its
    parts.  With ``return_identifier_mappings`` also the control and
    noise identifier mappings per pulse position."""
    try:
        pulses = tuple(pulses)
    except TypeError:
        raise TypeError(f'Expected pulses to be iterable, not '
                        f'{type(pulses)}')
    uniq = _distinct(pulses).values()
    if len(pulses) > 1 and len(uniq) == 1:
        newpulse = _uniform_newpulse(pulses[0], len(pulses))
        if return_identifier_mappings:
            shared_c = {str(i): str(i) for i in pulses[0].c_oper_identifiers}
            shared_n = {str(i): str(i) for i in pulses[0].n_oper_identifiers}
            return (newpulse, {p: shared_c for p in range(len(pulses))},
                    {p: shared_n for p in range(len(pulses))})
        return newpulse
    if len({p.d for p in uniq}) != 1:
        raise ValueError('Trying to concatenate PulseSequence instances '
                         'with different dimension!')
    if not util.all_array_equal((p.basis.np for p in uniq)):
        raise ValueError('Trying to concatenate PulseSequence instances '
                         'with different bases!')

    control = _concatenate_hamiltonian(
        [p.c_opers for p in pulses], [p.c_oper_identifiers for p in pulses],
        [p.c_coeffs for p in pulses], kind='control')
    noise = _concatenate_hamiltonian(
        [p.n_opers for p in pulses], [p.n_oper_identifiers for p in pulses],
        [p.n_coeffs for p in pulses], kind='noise')
    dt = np.concatenate([p.dt for p in pulses])

    newpulse = PulseSequence.from_arrays(*control[:3], *noise[:3], dt,
                                         pulses[0].basis,
                                         device=pulses[0].device)
    tau_by_id = {id(p): p.tau for p in uniq}
    newpulse.tau = sum(tau_by_id[id(p)] for p in pulses)
    if return_identifier_mappings:
        return newpulse, control[3], noise[3]
    return newpulse


# -----------------------------------------------------------------------------
# Concatenation with reuse of the cached control matrices
# -----------------------------------------------------------------------------
def _uniform_newpulse(pulse: PulseSequence, repeats: int) -> PulseSequence:
    """*repeats* repetitions of *pulse* without filter functions:
    operators and identifiers pass through, coefficients and durations
    tile."""
    if not isinstance(pulse, PulseSequence):
        raise TypeError('Can only concatenate PulseSequences!')
    newpulse = PulseSequence.from_arrays(
        c_opers=pulse.c_opers,
        c_oper_identifiers=pulse.c_oper_identifiers,
        c_coeffs=np.tile(pulse.c_coeffs, (1, repeats)),
        n_opers=pulse.n_opers,
        n_oper_identifiers=pulse.n_oper_identifiers,
        n_coeffs=np.tile(pulse.n_coeffs, (1, repeats)),
        dt=np.tile(pulse.dt, repeats),
        basis=pulse.basis, device=pulse.device)
    newpulse.tau = repeats * pulse.tau
    return newpulse


def _cache_periodic(newpulse: PulseSequence, pulse: PulseSequence,
                    repeats: int, omega, which: str = 'fidelity',
                    show_progressbar: bool = False) -> None:
    """Cache, on *newpulse* = *repeats* repetitions of *pulse*, the total
    propagator Q^G and the filter function (with it the total phases and
    the total transfer matrix) from the
    closed-form control matrix of
    :func:`.numeric.calculate_control_matrix_periodic`: the boundary
    phases are z^g with z = e^{i w tau} and the cumulative transfer
    matrices Q^g, so the sum over atomic control matrices is a geometric
    series."""
    control_matrix_atomic = pulse.get_control_matrix(omega, show_progressbar)
    if not newpulse.is_cached('total_propagator'):
        newpulse.total_propagator = util.matrix_power(
            pulse.total_propagator, repeats)
    control_matrix = numeric.calculate_control_matrix_periodic(
        pulse.get_total_phases(omega), control_matrix_atomic,
        pulse.total_propagator_liouville, repeats)
    newpulse.cache_filter_function(omega, control_matrix, which=which)


def _concatenate_uniform(pulse: PulseSequence, repeats: int,
                         calc_filter_function: Optional[bool], which: str,
                         omega, show_progressbar: bool) -> PulseSequence:
    """``concatenate([pulse] * repeats)`` without per-position work on
    the host, with the decisions of the general path."""
    newpulse = _uniform_newpulse(pulse, repeats)
    if pulse.is_cached('total_propagator'):
        newpulse.total_propagator = util.matrix_power(
            pulse.total_propagator, repeats)
    if calc_filter_function is False:
        return newpulse
    if omega is None:
        cached_ctrl = pulse.is_cached('control_matrix')
        if not (cached_ctrl or pulse.is_cached('omega')):
            if calc_filter_function:
                raise ValueError('Calculation of filter function forced '
                                 'but not all pulses have the same '
                                 'frequencies cached and none were '
                                 'supplied!')
            return newpulse
        if calc_filter_function is None and not cached_ctrl:
            return newpulse
        omega = pulse.omega
    _cache_periodic(newpulse, pulse, repeats, omega, which, show_progressbar)
    return newpulse


def _stack(items: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack tensors along a new leading axis: the distinct objects are
    stacked once and gathered by index, so a long list of few distinct
    tensors costs one small stack and one gather."""
    slot: Dict[int, int] = {}
    distinct = []
    idx = np.empty(len(items), np.int64)
    for i, item in enumerate(items):
        k = slot.get(id(item))
        if k is None:
            k = slot[id(item)] = len(distinct)
            distinct.append(item)
        idx[i] = k
    base = torch.stack(distinct)
    if len(distinct) == len(items):
        return base
    return base[torch.as_tensor(idx, device=base.device)]


@util.parse_optional_parameters(which=('fidelity', 'generalized'))
def concatenate(pulses: Iterable[PulseSequence],
                calc_pulse_correlation_FF: bool = False,
                calc_filter_function: Optional[bool] = None,
                calc_second_order_FF: Optional[bool] = None,
                which: str = 'fidelity',
                omega: Optional[Coefficients] = None,
                show_progressbar: bool = False) -> PulseSequence:
    r"""Concatenate pulses in time, left to right (B after A for
    (A, B)), reusing the cached control matrices of the parts: the
    control matrix of the sequence is
    :func:`.numeric.calculate_control_matrix_from_atomic` of theirs.

    The filter function is computed if ``calc_filter_function`` is True
    (at *omega*, or at the parts' cached frequencies), not if it is
    False, and by default if a part has a cached control matrix and the
    parts share a noise operator.  ``calc_pulse_correlation_FF`` keeps
    the summands and caches the pulse-correlation filter function,
    ``calc_second_order_FF`` the second-order one by the concatenation
    rule (the parts need their second-order intermediates cached);
    *which* is 'fidelity' or 'generalized'.  The new pulse lives on the
    device of its parts.
    """
    pulses = tuple(pulses)
    if len(pulses) == 1:
        return _copy.copy(pulses[0])

    if (not calc_pulse_correlation_FF and not calc_second_order_FF
            and len(set(map(id, pulses))) == 1):
        # one repeated pulse object answers every union, mapping and
        # cache question, and the sum is the periodic closed form
        return _concatenate_uniform(pulses[0], len(pulses),
                                    calc_filter_function, which, omega,
                                    show_progressbar)

    newpulse, _, n_oper_mapping = concatenate_without_filter_function(
        pulses, return_identifier_mappings=True)

    # per-pulse properties once per distinct object, fanned out by id
    pulse_ids = [id(p) for p in pulses]
    uniq_pulses = dict(zip(pulse_ids, pulses))

    def per_pulse(fn):
        vals = {k: fn(p) for k, p in uniq_pulses.items()}
        return [vals[i] for i in pulse_ids]

    def cumulative_propagators():
        """Q_g ... Q_0 for every position g, (G, d, d)."""
        return util.adot(_stack(per_pulse(lambda p: p.total_propagator)))

    def set_total_propagator():
        if (not newpulse.is_cached('total_propagator')
                and all(p.is_cached('total_propagator')
                        for p in uniq_pulses.values())):
            newpulse.total_propagator = cumulative_propagators()[-1]

    if calc_pulse_correlation_FF or calc_second_order_FF is True:
        calc_filter_function = True
    if calc_filter_function is False:
        set_total_propagator()
        return newpulse

    # pulse_rows[i][j] is the row of the merged, identifier-sorted noise
    # operators that row j of pulse i's control matrix belongs to.  A
    # rename can change the relative order, so cached rows are scattered
    # by position, not by mask.
    unique_identifiers = sorted({new for mapping in n_oper_mapping.values()
                                 for new in mapping.values()})
    row_of = {ident: k for k, ident in enumerate(unique_identifiers)}
    pulse_rows = []
    rows_memo: Dict[tuple, np.ndarray] = {}
    for i, pulse in enumerate(pulses):
        mapping = n_oper_mapping[i]
        key = (id(pulse.n_oper_identifiers), id(mapping))
        rows = rows_memo.get(key)
        if rows is None:
            rows = rows_memo[key] = np.array(
                [row_of[mapping[str(old)]]
                 for old in pulse.n_oper_identifiers])
        pulse_rows.append(rows)
    n_opers_present = np.zeros((len(pulses), len(unique_identifiers)),
                               dtype=bool)
    for i, rows in enumerate(pulse_rows):
        n_opers_present[i, rows] = True

    if calc_second_order_FF and not n_opers_present.all():
        warn('Second order FF requested but not all pulses have the same '
             'n_opers. Not implemented.', UserWarning)
        calc_second_order_FF = False

    equal_n_opers = (n_opers_present.sum(axis=0) > 1).any()
    if omega is None:
        cached_ctrl_mat = per_pulse(lambda p: p.is_cached('control_matrix'))
        if any(cached_ctrl_mat):
            equal_omega = util.all_array_equal(
                (p.omega for p, c in zip(pulses, cached_ctrl_mat) if c))
        else:
            cached_omega = per_pulse(lambda p: p.is_cached('omega'))
            equal_omega = util.all_array_equal(
                (p.omega for p, c in zip(pulses, cached_omega) if c))
        if not equal_omega:
            if calc_filter_function:
                raise ValueError('Calculation of filter function forced '
                                 'but not all pulses have the same '
                                 'frequencies cached and none were '
                                 'supplied!')
            set_total_propagator()
            return newpulse
        if calc_filter_function is None and (
                not equal_n_opers or not any(cached_ctrl_mat)):
            set_total_propagator()
            return newpulse
        if any(cached_ctrl_mat):
            ind = int(np.nonzero(cached_ctrl_mat)[0][0])
        else:
            ind = int(np.nonzero(cached_omega)[0][0])
        omega = pulses[ind].omega

    if not equal_n_opers:
        # nothing to reuse: compute afresh on the merged pulse
        set_total_propagator()
        newpulse.cache_filter_function(omega, which=which)
        return newpulse

    # the summands are needed for the pulse-correlation filter function
    # and for the second-order concatenation rule
    keep_steps = bool(calc_pulse_correlation_FF or calc_second_order_FF)

    # atomic control matrices in the new noise-operator order, once per
    # distinct pulse
    device = newpulse.device
    n_nops_new = len(newpulse.n_opers)
    seg_bounds = [0] + list(accumulate(len(p.dt) for p in pulses))
    expected = np.arange(n_nops_new)
    if all(np.array_equal(rows, expected) for rows in rows_memo.values()):
        control_matrix_atomic = _stack(per_pulse(
            lambda p: p.get_control_matrix(omega, show_progressbar)))
    else:
        atomic = []
        for i, (pulse, rows) in enumerate(zip(pulses, pulse_rows)):
            ctrl = pulse.get_control_matrix(omega, show_progressbar)
            full = ctrl.new_zeros((n_nops_new, *ctrl.shape[1:]))
            full[torch.as_tensor(rows, device=device)] = ctrl
            missing = ~n_opers_present[i]
            if missing.any():
                # rows of operators this pulse lacks, from scratch
                full[torch.as_tensor(missing, device=device)] = \
                    numeric.calculate_control_matrix_from_scratch(
                        pulse.eigvals, pulse.eigvecs, pulse.propagators,
                        omega, pulse.basis, newpulse.n_opers[missing],
                        newpulse.n_coeffs[missing,
                                          seg_bounds[i]:seg_bounds[i + 1]],
                        pulse.dt, t=pulse.t,
                        show_progressbar=show_progressbar)
            atomic.append(full)
        control_matrix_atomic = torch.stack(atomic)

    # the boundary phases e^{i w t_g}, t_g the cumulative durations: one
    # angle per boundary in float64, no cumulative product
    omega_dev = torch.as_tensor(omega, dtype=torch.float64, device=device)
    t_bound = torch.as_tensor(np.cumsum(per_pulse(lambda p: p.tau)[:-1]),
                              device=device)
    phases = util.cexp(t_bound[:, None] * omega_dev)        # (G-1, n_w)

    # cumulative transfer matrices of the boundaries: real for a
    # Hermitian, normalized basis, complex otherwise
    propagators_liouville = util.adot(_stack(per_pulse(
        lambda p: p.total_propagator_liouville)[:-1]))

    propagators = cumulative_propagators()
    if not newpulse.is_cached('total_propagator'):
        newpulse.total_propagator = propagators[-1]

    control_matrix = numeric.calculate_control_matrix_from_atomic(
        phases, control_matrix_atomic, propagators_liouville,
        show_progressbar, which='correlations' if keep_steps else 'total')

    if calc_second_order_FF:
        ctrl_step = control_matrix
        ctrl_cumulative = ctrl_step.cumsum(0)
        if not calc_pulse_correlation_FF:
            control_matrix = ctrl_cumulative[-1]
        ff2 = numeric.calculate_second_order_filter_function_from_atomic(
            basis=newpulse.basis,
            filter_function_atomic=pulses[0].get_filter_function(
                omega, order=2),
            control_matrix_atomic=control_matrix_atomic,
            control_matrix_atomic_step=ctrl_step,
            control_matrix_atomic_cumulative=ctrl_cumulative,
            propagators=propagators[:-1],
            propagators_liouville=propagators_liouville,
            intermediates=[p.intermediates for p in pulses],
            show_progressbar=show_progressbar)
        newpulse.cache_filter_function(omega, filter_function=ff2, order=2)

    newpulse.cache_filter_function(omega, control_matrix, which=which)
    return newpulse


def concatenate_periodic(pulse: PulseSequence, repeats: int,
                         check_invertible: bool = True) -> PulseSequence:
    r"""Repeat *pulse* *repeats* times; if its control matrix is cached,
    the new pulse's comes from the closed-form geometric series
    (:func:`.numeric.calculate_control_matrix_periodic`).
    *check_invertible* is accepted and ignored: the series is summed by
    doubling, not by an inverse."""
    newpulse = _uniform_newpulse(pulse, repeats)
    if pulse.is_cached('control_matrix'):
        _cache_periodic(newpulse, pulse, repeats, pulse.omega)
    return newpulse


# -----------------------------------------------------------------------------
# remap / extend: composition in space
# -----------------------------------------------------------------------------
def _map_identifiers(identifiers, mapping):
    """(remapped identifiers, the order that sorts them)."""
    if mapping is None:
        return np.asarray(identifiers), np.arange(len(identifiers))
    remapped = np.array([mapping[i] for i in identifiers])
    return remapped, np.argsort(remapped)


def _default_extend_mapping(identifiers, mapping, qubits):
    """The identifier mapping of extend: *mapping* if given, else the
    target qubit indices appended, ``'X'`` on qubits (0, 2) -> ``'X_02'``."""
    if mapping is not None:
        return identifiers, mapping
    try:
        suffix = ('{}' * len(qubits)).format(*qubits)
    except TypeError:
        suffix = f'{qubits}'
    return identifiers, {q: f'{q}_{suffix}' for q in identifiers}


def remap(pulse: PulseSequence, order: Sequence[int], d_per_qubit: int = 2,
          oper_identifier_mapping: Optional[Mapping[str, str]] = None
          ) -> PulseSequence:
    """Permute the qubits of *pulse* into *order*, keeping its caches.

    Operators and cached eigendecompositions and propagators are
    permuted by :func:`.util.tensor_transpose`, the cached filter
    function by the identifier order.  The cached control matrix and
    total Liouville propagator are permuted by index on the device,
    which needs a Pauli basis: for another basis they are dropped with a
    warning.  The new pulse lives on *pulse*'s device.
    """
    n_qubits = int(round(np.log(pulse.d) / np.log(d_per_qubit)))
    dims = [[d_per_qubit] * n_qubits] * 2

    c_opers = util.tensor_transpose(pulse.c_opers, order, dims)
    n_opers = util.tensor_transpose(pulse.n_opers, order, dims)
    c_ids, c_sort = _map_identifiers(pulse.c_oper_identifiers,
                                     oper_identifier_mapping)
    n_ids, n_sort = _map_identifiers(pulse.n_oper_identifiers,
                                     oper_identifier_mapping)

    remapped = PulseSequence.from_arrays(
        c_opers=c_opers[c_sort], n_opers=n_opers[n_sort],
        c_oper_identifiers=c_ids[c_sort], n_oper_identifiers=n_ids[n_sort],
        c_coeffs=pulse.c_coeffs[c_sort], n_coeffs=pulse.n_coeffs[n_sort],
        dt=pulse.dt, basis=pulse.basis, device=pulse.device)
    if 't' in pulse.data:
        remapped.t = pulse.t
    if 'tau' in pulse.data:
        remapped.tau = pulse.tau

    if pulse.is_cached('eigvals'):
        remapped.eigvals = util.tensor_transpose(
            pulse.eigvals, order, [[d_per_qubit] * n_qubits], rank=1)
    for attr in ('eigvecs', 'propagators', 'total_propagator'):
        if pulse.is_cached(attr):
            setattr(remapped, attr,
                    util.tensor_transpose(getattr(pulse, attr), order, dims))

    if not pulse.is_cached('omega'):
        return remapped
    omega = pulse.omega
    sort = torch.as_tensor(n_sort, device=pulse.device)
    if pulse.is_cached('total_phases'):
        remapped.cache_total_phases(omega, pulse.get_total_phases(omega))
    if pulse.is_cached('filter_function'):
        remapped.cache_filter_function(
            omega, filter_function=pulse.get_filter_function(
                omega)[sort][:, sort])

    if pulse.is_cached('total_propagator_liouville') \
            or pulse.is_cached('control_matrix'):
        if pulse.basis.btype != 'Pauli':
            warn('pulse does not have a separable basis which is needed to '
                 'retain cached control matrices.')
            return remapped
        # new[a, k] = old[n_sort[a], inv_perm[k]]
        inv_perm = torch.as_tensor(
            np.argsort(remap_pauli_basis_elements(order, n_qubits)),
            device=pulse.device)
        if pulse.is_cached('total_propagator_liouville'):
            remapped.total_propagator_liouville = \
                pulse.total_propagator_liouville[inv_perm][:, inv_perm]
        if pulse.is_cached('control_matrix'):
            remapped.cache_control_matrix(
                omega, pulse.get_control_matrix(omega)[sort][:, inv_perm])
    return remapped


def _tensor_chain_merge(old_attrs, new_attrs, d_per_qubit, registers,
                        qubits):
    """Merge each new attribute into the growing tensor chain at the
    register positions of *qubits*."""
    if registers is None:
        return new_attrs, list(qubits)
    pos = [bisect.bisect(registers, q) for q in qubits]
    merged = [util.tensor_merge(old, new, pos=pos,
                                arr_dims=[[d_per_qubit] * len(registers)] * 2,
                                ins_dims=[[d_per_qubit] * len(pos)] * 2)
              for old, new in zip(old_attrs, new_attrs)]
    for q in qubits:
        bisect.insort(registers, q)
    return merged, registers


def _tensor_chain_insert(old_attrs, new_attrs, d_per_qubit, registers,
                         qubit):
    """Insert each new attribute into the chain at the register position
    of the single *qubit*."""
    if registers is None:
        return new_attrs, [qubit]
    pos = bisect.bisect(registers, qubit)
    inserted = [util.tensor_insert(
        old, new, pos=pos, arr_dims=[[d_per_qubit] * len(registers)] * 2)
        for old, new in zip(old_attrs, new_attrs)]
    bisect.insort(registers, qubit)
    return inserted, registers


def extend(pulse_to_qubit_mapping: PulseMapping, N: Optional[int] = None,
           d_per_qubit: int = 2,
           additional_noise_Hamiltonian: Optional[Hamiltonian] = None,
           cache_diagonalization: Optional[bool] = None,
           cache_filter_function: Optional[bool] = None,
           omega: Optional[Coefficients] = None,
           show_progressbar: bool = False) -> PulseSequence:
    r"""Map pulses onto (subsets of) a register of *N* qubits.

    *pulse_to_qubit_mapping* holds ``(pulse, qubit or qubits[,
    identifier mapping])`` entries; a pulse on unsorted qubits is
    :func:`remap`\ ped first.  Identifiers get the target qubits
    appended unless a mapping is given.  *additional_noise_Hamiltonian*
    adds noise operators of the whole register.

    The new pulse lives on the device of its parts.  For Pauli bases
    the cached diagonalizations (or total propagators) are tensored
    together on the device, and the cached control matrices scattered
    into one control matrix of the register: the rows of each part at
    the Pauli elements that act on its qubits, times sqrt(s), s =
    d_per_qubit^(N - n).  The rows of the additional noise operators
    are computed from scratch (:func:`.numeric.
    calculate_control_matrix_from_scratch`, on CUDA the deep factored
    route).  The cached filter function is that of the complete control
    matrix, cross terms between parts and additional operators
    included.  Other bases are diagonalized and computed from scratch.

    *cache_diagonalization* and *cache_filter_function* default to
    whether every part has them cached (and one frequency grid); the
    filter function needs the diagonalization when there are additional
    noise operators.
    """
    # ---- parse mapping ----
    single_pulses, single_idx, single_maps = [], [], []
    multi_pulses, multi_idx, multi_maps = [], [], []
    active: List[int] = []
    for entry in pulse_to_qubit_mapping:
        pulse, qubit = entry[0], entry[1]
        id_mapping = entry[2] if len(entry) > 2 else None
        if util.is_sequence_like(qubit) and not isinstance(
                qubit, (int, np.integer)):
            qubit = tuple(int(q) for q in qubit)
            active.extend(qubit)
            if len(qubit) == 1:
                single_idx.append(qubit[0])
                single_pulses.append(pulse)
                single_maps.append(id_mapping)
                continue
            sorted_qubit, order = zip(*sorted(zip(qubit, range(len(qubit)))))
            if qubit == sorted_qubit:
                sorted_pulse = pulse
            else:
                try:
                    sorted_pulse = remap(pulse, order, d_per_qubit)
                except ValueError as err:
                    raise ValueError(f'Could not remap {pulse!r} mapped to '
                                     f'qubits {qubit}. Do the dimensions '
                                     'match?') from err
            multi_idx.append(list(sorted_qubit))
            multi_pulses.append(sorted_pulse)
            multi_maps.append(id_mapping)
        else:
            active.append(int(qubit))
            single_idx.append(int(qubit))
            single_pulses.append(pulse)
            single_maps.append(id_mapping)

    if not all(p.d == d_per_qubit for p in single_pulses):
        raise ValueError('Not all single-qubit pulses have dimension '
                         f'd_per_qubit = {d_per_qubit}.')
    if not all(p.d == d_per_qubit**len(q)
               for p, q in zip(multi_pulses, multi_idx)):
        raise ValueError('Not all multi-qubit pulses have correct '
                         'dimension!')

    pulses = multi_pulses + single_pulses
    idx = multi_idx + single_idx
    if len({p.device for p in pulses}) != 1:
        raise ValueError('Trying to extend PulseSequence instances on '
                         'different devices!')
    device = pulses[0].device
    if not util.all_array_equal((p.dt for p in pulses)):
        raise ValueError('All pulses should be defined on the same time '
                         'steps')
    active_set = set(active)
    if len(active_set) != len(active):
        raise ValueError('Qubit clash: multiple pulses mapped to same '
                         'qubit!')
    last_qubit = max(active_set)
    if N is None:
        N = last_qubit + 1
    elif last_qubit + 1 > N:
        raise ValueError('Number of qubits N smaller than highest qubit '
                         f'index + 1 = {last_qubit + 1}')

    if len(pulse_to_qubit_mapping) == 1:
        if multi_idx and N == len(multi_idx[0]):
            warn('Single multi-qubit pulse given and mapped to its '
                 'original qubits. Returning the same.')
            return multi_pulses[0]
        if single_idx and N == 1:
            warn('Single single-qubit pulse given and mapped to its '
                 'original qubit. Returning the same.')
            return single_pulses[0]

    # ---- decide what to cache ----
    if cache_filter_function is not False:
        have_ctrl = all(p.is_cached('control_matrix') for p in pulses)
        try:
            equal_omega = util.all_array_equal((p.omega for p in pulses))
        except (AttributeError, TypeError):
            equal_omega = False
        if cache_filter_function is None:
            cache_filter_function = have_ctrl and equal_omega
            if cache_filter_function:
                omega = pulses[0].omega
        elif omega is None:
            if not equal_omega:
                raise ValueError('Filter function should be cached but '
                                 'omega was not provided and could not be '
                                 'inferred.')
            omega = pulses[0].omega

    if cache_diagonalization is None:
        if cache_filter_function and additional_noise_Hamiltonian is not None:
            cache_diagonalization = True
        else:
            cache_diagonalization = all(
                p.is_cached(attr) for attr in ('eigvals', 'eigvecs',
                                               'propagators')
                for p in pulses)
    elif not cache_diagonalization \
            and additional_noise_Hamiltonian is not None:
        raise ValueError('Additional noise Hamiltonian given and '
                         'cache_diagonalization set to False but required.')

    # ---- extended operators (host) ----
    all_qubits = set(range(N))
    d = d_per_qubit**N
    n_dt = len(pulses[0].dt)
    ident = np.identity(d_per_qubit)

    c_opers, c_ids, c_coeffs = [], [], []
    n_opers, n_ids, n_coeffs = [], [], []
    for pulse, qubits, id_map in zip(multi_pulses, multi_idx, multi_maps):
        pos = [bisect.bisect(qubits, q)
               for q in sorted(all_qubits.difference(qubits))]
        c_id, _ = _map_identifiers(*_default_extend_mapping(
            pulse.c_oper_identifiers, id_map, qubits))
        n_id, _ = _map_identifiers(*_default_extend_mapping(
            pulse.n_oper_identifiers, id_map, qubits))
        c_ids.extend(c_id)
        n_ids.extend(n_id)
        arr_dims = [[d_per_qubit] * len(qubits)] * 2
        c_opers.extend(util.tensor_insert(
            pulse.c_opers, *[ident] * len(pos), pos=pos, arr_dims=arr_dims))
        n_opers.extend(util.tensor_insert(
            pulse.n_opers, *[ident] * len(pos), pos=pos, arr_dims=arr_dims))
        c_coeffs.extend(pulse.c_coeffs)
        n_coeffs.extend(pulse.n_coeffs)

    for pulse, qubit, id_map in zip(single_pulses, single_idx, single_maps):
        pre = [np.identity(d_per_qubit**qubit)] if qubit > 0 else []
        post = [np.identity(d_per_qubit**(N - qubit - 1))] \
            if qubit < N - 1 else []
        c_id, _ = _map_identifiers(*_default_extend_mapping(
            pulse.c_oper_identifiers, id_map, qubit))
        n_id, _ = _map_identifiers(*_default_extend_mapping(
            pulse.n_oper_identifiers, id_map, qubit))
        c_ids.extend(c_id)
        n_ids.extend(n_id)
        c_opers.extend(util.tensor(*(pre + [pulse.c_opers] + post)))
        n_opers.extend(util.tensor(*(pre + [pulse.n_opers] + post)))
        c_coeffs.extend(pulse.c_coeffs)
        n_coeffs.extend(pulse.n_coeffs)

    n_from_pulses = len(n_ids)
    if additional_noise_Hamiltonian is not None:
        add_opers, add_ids, add_coeffs = _parse_hamiltonian(
            additional_noise_Hamiltonian, n_dt, 'H_n')
        if add_opers.shape[1:] != (d, d):
            raise ValueError('Expected additional noise operators to have '
                             f'dimensions {(d, d)}, not '
                             f'{add_opers.shape[1:]}.')
        clash = set(n_ids).intersection(add_ids)
        if clash:
            raise ValueError('Found duplicate noise operator identifiers: '
                             f'{clash}')
        n_opers.extend(add_opers)
        n_coeffs.extend(add_coeffs)
        n_ids.extend(add_ids)

    btypes = {p.basis.btype for p in pulses}
    if len(btypes) != 1:
        warn('Not all pulses had the same basis type. Cannot retain cached '
             'control matrices.')
        new_basis = Basis.ggm(d)
    elif btypes == {'GGM'}:
        warn('Original pulses had GGM basis which is not separable into a '
             'tensor product. Cannot retain cached control matrices.')
        new_basis = Basis.ggm(d)
    elif btypes == {'Pauli'}:
        new_basis = Basis.pauli(N)
    else:
        warn('Original pulses had custom basis which I cannot extend.')
        new_basis = Basis.ggm(d)

    c_sort = np.argsort(c_ids)
    n_sort = np.argsort(n_ids)
    newpulse = PulseSequence.from_arrays(
        c_opers=np.asarray(c_opers)[c_sort],
        n_opers=np.asarray(n_opers)[n_sort],
        c_oper_identifiers=np.asarray(c_ids)[c_sort],
        n_oper_identifiers=np.asarray(n_ids)[n_sort],
        c_coeffs=np.asarray(c_coeffs)[c_sort],
        n_coeffs=np.asarray(n_coeffs)[n_sort],
        dt=pulses[0].dt, basis=new_basis, device=device)
    if 't' in pulses[0].data:
        newpulse.t = pulses[0].t
    if 'tau' in pulses[0].data:
        newpulse.tau = pulses[0].tau

    if newpulse.basis.btype != 'Pauli':
        if cache_diagonalization:
            newpulse.diagonalize()
        if cache_filter_function:
            newpulse.cache_filter_function(omega)
        return newpulse

    # ---- tensor the cached diagonalizations together (device) ----
    id_idx = sorted(all_qubits.difference(active_set))
    filler = torch.eye(d_per_qubit**len(id_idx), dtype=config.COMPLEX,
                       device=device)
    if cache_diagonalization:
        # a Kronecker sum: not in ascending order, and nothing downstream
        # needs it to be
        eigvals = torch.zeros((n_dt, d), dtype=config.REAL, device=device)
        attrs = [None, None]            # eigvecs, propagators
        registers = None
        for pulse, qubits in zip(multi_pulses, multi_idx):
            hd_pos = [bisect.bisect(qubits, q)
                      for q in sorted(all_qubits.difference(qubits))]
            eigvals = eigvals + util.tensor_insert(
                pulse.eigvals, *np.ones((len(hd_pos), d_per_qubit)),
                pos=hd_pos, rank=1, arr_dims=[[d_per_qubit] * len(qubits)])
            attrs, registers = _tensor_chain_merge(
                attrs, [pulse.eigvecs, pulse.propagators], d_per_qubit,
                registers, qubits)
        for pulse, qubit in zip(single_pulses, single_idx):
            pre = [np.ones(d_per_qubit**qubit)] if qubit > 0 else []
            post = [np.ones(d_per_qubit**(N - qubit - 1))] \
                if qubit < N - 1 else []
            eigvals = eigvals + util.tensor(*(pre + [pulse.eigvals] + post),
                                            rank=1)
            attrs, registers = _tensor_chain_insert(
                attrs, [pulse.eigvecs, pulse.propagators], d_per_qubit,
                registers, qubit)
        if id_idx:
            attrs, registers = _tensor_chain_merge(
                attrs, [filler, filler], d_per_qubit, registers, id_idx)
        newpulse.eigvals = eigvals
        newpulse.eigvecs = attrs[0]
        newpulse.propagators = attrs[1]
        newpulse.total_propagator = attrs[1][-1]
    elif all(p.is_cached('total_propagator') for p in pulses):
        attrs = [None]
        registers = None
        for pulse, qubits in zip(multi_pulses, multi_idx):
            attrs, registers = _tensor_chain_merge(
                attrs, [pulse.total_propagator], d_per_qubit, registers,
                qubits)
        for pulse, qubit in zip(single_pulses, single_idx):
            attrs, registers = _tensor_chain_insert(
                attrs, [pulse.total_propagator], d_per_qubit, registers,
                qubit)
        if id_idx:
            attrs, registers = _tensor_chain_merge(
                attrs, [filler], d_per_qubit, registers, id_idx)
        newpulse.total_propagator = attrs[0]

    if not cache_filter_function:
        return newpulse

    # ---- the control matrix of the register (device) ----
    # only first-order quantities are extended; say so if a part carried
    # more
    dropped = sorted({
        name for p in pulses for name, key in
        (('second order filter function', 'filter_function_2'),
         ('pulse correlation filter function', 'filter_function_pc'),
         ('generalized pulse correlation filter function',
          'filter_function_pc_gen'))
        if p.is_cached(key)})
    if dropped:
        warn('extend() only extends first-order control matrices and '
             'fidelity filter functions; cached ' + ', '.join(dropped)
             + ' of the input pulses are discarded and must be recomputed '
             'on the extended pulse.', UserWarning)
    newpulse.omega = omega
    omega = newpulse.omega
    control_matrix = torch.zeros((len(n_ids), d * d, len(omega)),
                                 dtype=config.COMPLEX, device=device)
    counter = 0
    for ind, pulse in zip(idx, pulses):
        ind_list = [ind] if isinstance(ind, (int, np.integer)) else ind
        rows = torch.arange(counter, counter + len(pulse.n_opers),
                            device=device)
        cols = torch.as_tensor(equivalent_pauli_basis_elements(ind_list, N),
                               device=device)
        counter += len(pulse.n_opers)
        control_matrix.index_put_(
            (rows[:, None], cols[None, :]),
            pulse.get_control_matrix(omega, show_progressbar)
            * math.sqrt(d_per_qubit**(N - len(ind_list))))
    if additional_noise_Hamiltonian is not None:
        inds = util.get_indices_from_identifiers(
            newpulse.n_oper_identifiers, list(n_ids[n_from_pulses:]))
        control_matrix[n_from_pulses:] = \
            numeric.calculate_control_matrix_from_scratch(
                newpulse.eigvals, newpulse.eigvecs, newpulse.propagators,
                omega, newpulse.basis, newpulse.n_opers[inds],
                newpulse.n_coeffs[inds], newpulse.dt, t=newpulse.t,
                show_progressbar=show_progressbar)
    newpulse.cache_filter_function(
        omega, control_matrix[torch.as_tensor(n_sort, device=device)])
    return newpulse
