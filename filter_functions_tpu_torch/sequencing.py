"""Pulse composition in time (counterpart of the concatenation half of
``filter_functions_tpu.sequencing``): :func:`concatenate`,
:func:`concatenate_periodic` and
:func:`concatenate_without_filter_function`.

The identifier and hash bookkeeping is host-side string and index
logic on numpy arrays; it decides which cached control matrices are
reused.  The array math (boundary phases, cumulative propagators, the
sum over atomic control matrices, the closed-form periodic series) runs
on the pulses' device through :mod:`.numeric`.

Long trains repeat few pulse objects.  All bookkeeping is therefore done
once per distinct object (keyed by ``id``), and the per-position stacks
the device math needs are one ``torch.stack`` of the distinct tensors
gathered by one index.
"""
from __future__ import annotations

import bisect
import copy as _copy
from itertools import accumulate
from typing import Dict, Iterable, List, Optional, Sequence
from warnings import warn

import numpy as np
import torch

from . import numeric, util
from .pulse_sequence import PulseSequence
from .types import Coefficients

__all__ = ['concatenate', 'concatenate_periodic',
           'concatenate_without_filter_function']


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
