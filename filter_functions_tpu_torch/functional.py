"""Functional pipeline API of the PyTorch port (counterpart of
``filter_functions_tpu.functional``): the control matrix, the
infidelity and the error transfer matrix of pulses given as plain
tensors.

A pulse is a :class:`PulseArrays` of tensors.  Batched functions take a
leading batch axis on ``c_coeffs``, ``n_coeffs`` and ``dt`` and share
the operators and the basis, as the JAX package's ``vmap`` does.

``control_matrix``, ``fidelity_filter_function``, ``infidelity`` and
``batched_infidelity`` are differentiable in the tensors of the pulse
(``torch.autograd``) on both contraction routes, at degenerate spectra
too; the escalation decision stays outside the graph.  So are the
error transfer matrices, first and second order (:func:`_etm_core`).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import config, numeric, tracing, util
from .basis import Basis
from .numeric import _escalates

__all__ = ['PulseArrays', 'make_pulse_arrays', 'control_matrix',
           'fidelity_filter_function', 'infidelity', 'batched_infidelity',
           'error_transfer_matrix', 'batched_error_transfer_matrix']


class PulseArrays(NamedTuple):
    """The static ingredients of a pulse."""
    c_opers: torch.Tensor    # (n_ctrl, d, d) complex128
    c_coeffs: torch.Tensor   # (..., n_ctrl, G) float64
    n_opers: torch.Tensor    # (n_nops, d, d) complex128
    n_coeffs: torch.Tensor   # (..., n_nops, G) float64
    dt: torch.Tensor         # (..., G) float64
    basis: torch.Tensor      # (n_b, d, d) complex128


def make_pulse_arrays(pulse) -> PulseArrays:
    """:class:`PulseArrays` of a :class:`~.pulse_sequence.PulseSequence`,
    on the pulse's device."""
    return PulseArrays(pulse.c_opers_dev, pulse._dev_arr('c_coeffs'),
                       pulse.n_opers_dev, pulse._dev_arr('n_coeffs'),
                       pulse._dev_arr('dt'), pulse.basis.tensor(pulse.device))


def _diagonalized(p: PulseArrays, c_coeffs: torch.Tensor,
                  n_coeffs: torch.Tensor, dt: torch.Tensor,
                  omega: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             Tuple[torch.Tensor, ...]]:
    """(Hamiltonians, eigvals, eigvecs, per-segment step terms) of the
    pulses with these coefficients and durations (any leading batch
    axes)."""
    ham = torch.einsum('jmn,...jg->...gmn', p.c_opers,
                       c_coeffs.to(p.c_opers.dtype))
    eigvals, eigvecs, propagators = numeric.diagonalize(ham, dt)
    zero = torch.zeros_like(dt[..., :1])
    t = torch.cat([zero, torch.cumsum(dt, -1)], -1)
    terms = numeric._ctrlmat_step_terms(
        eigvals, eigvecs, propagators[..., :-1, :, :], omega, p.basis,
        p.n_opers, n_coeffs, dt, t[..., :-1])
    return ham, eigvals, eigvecs, terms


def _prep(p: PulseArrays, c_coeffs: torch.Tensor, n_coeffs: torch.Tensor,
          dt: torch.Tensor, omega: torch.Tensor
          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                     Optional[torch.Tensor]]:
    """Diagonalization and per-segment step terms of the pulses with
    these coefficients and durations (any leading batch axes): (eigvals,
    step terms, the degenerate-eigenspace term of the control matrix,
    :func:`.numeric._degenerate_control_matrix`, or None)."""
    with tracing.span('ff.prep'):
        region = tracing.backward_span('ff.prep.backward', c_coeffs,
                                       n_coeffs, dt)
        c_coeffs, n_coeffs, dt = region.inputs
        ham, eigvals, eigvecs, terms = _diagonalized(p, c_coeffs, n_coeffs,
                                                     dt, omega)
        degenerate = numeric._degenerate_control_matrix(
            ham, eigvals, eigvecs, terms, omega, dt)
        eigvals, *terms, degenerate = region.outputs(eigvals, *terms,
                                                     degenerate)
        return eigvals, tuple(terms), degenerate


def _contract(terms: Tuple[torch.Tensor, ...],
              degenerate: Optional[torch.Tensor], escalation: str,
              contract: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The control matrix of step terms (:func:`.numeric.
    _ctrlmat_contract`) plus its degenerate-eigenspace term, and the
    quantization ratio."""
    _, n_t, b_t, ph, integral = terms
    ctrl, ratio = numeric._ctrlmat_contract(n_t, integral, b_t, ph,
                                            escalation, contract)
    if degenerate is not None:
        ctrl = ctrl + degenerate
    return ctrl, ratio


def _infid_contract(terms: Tuple[torch.Tensor, ...], spectrum: torch.Tensor,
                    omega: torch.Tensor, d: int, escalation: str = 'stat',
                    contract: str = 'native',
                    degenerate: Optional[torch.Tensor] = None,
                    weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Control-matrix contraction and spectral integral of step terms.

    The integral is the trapezoid over *omega*, or with *weights* the
    weighted sum over these frequencies: a share of a frequency grid
    split across ranks takes its slice of the whole grid's
    :func:`.numeric.trapezoid_weights` (:mod:`.parallel.sharding`).

    Returns (infidelity (..., n_nops), ratio (...)), the ratio being the
    quantization statistic of the deep factored contraction (0 off that
    route)."""
    with tracing.span('ff.contract'):
        ctrl, ratio = _contract(terms, degenerate, escalation, contract)
        diag = (ctrl.real * ctrl.real + ctrl.imag * ctrl.imag).sum(-2)
        if weights is None:
            integral = util.integrate(diag * spectrum, omega)
        else:
            integral = (diag * spectrum * weights).sum(-1)
        return integral / (2 * math.pi * d), ratio


def control_matrix(p: PulseArrays, omega: torch.Tensor,
                   contract: Optional[str] = None,
                   escalation_tol: float = config.ESCALATION_TOL
                   ) -> torch.Tensor:
    """Control matrix (..., n_nops, n_b, n_omega) of the pulse(s) *p*.

    *contract* picks the contraction route (:func:`.config.
    contraction_mode`).  On the deep factored route the result is
    recomputed natively when its quantization statistic exceeds
    *escalation_tol* (0 disables the check)."""
    mode = config.contraction_mode(p.c_opers.device, contract)
    return _control_matrix(p, omega, mode, escalation_tol)


def _control_matrix(p: PulseArrays, omega: torch.Tensor, mode: str,
                    escalation_tol: float,
                    ratio_max: Optional[Callable] = None) -> torch.Tensor:
    """:func:`control_matrix` on the resolved route *mode*, the
    escalation decided by :func:`.numeric._escalates`."""
    _, terms, degenerate = _prep(p, p.c_coeffs, p.n_coeffs, p.dt, omega)
    ctrl, ratio = _contract(terms, degenerate, 'stat', mode)
    if _escalates(ratio, escalation_tol, ratio_max):
        ctrl, _ = _contract(terms, degenerate, 'force', mode)
    return ctrl


def fidelity_filter_function(p: PulseArrays, omega: torch.Tensor,
                             contract: Optional[str] = None,
                             escalation_tol: float = config.ESCALATION_TOL
                             ) -> torch.Tensor:
    """Fidelity filter function (..., n_nops, n_nops, n_omega) of the
    pulse(s) *p*."""
    ctrl = control_matrix(p, omega, contract, escalation_tol)
    return numeric.calculate_filter_function(ctrl, 'fidelity')


def infidelity(p: PulseArrays, spectrum: torch.Tensor, omega: torch.Tensor,
               contract: Optional[str] = None,
               escalation_tol: float = config.ESCALATION_TOL
               ) -> torch.Tensor:
    """Leading-order infidelity per noise operator (n_nops,) of one
    pulse for a per-operator (or broadcastable) spectrum."""
    batched = p._replace(c_coeffs=p.c_coeffs[None], n_coeffs=p.n_coeffs[None],
                         dt=p.dt[None])
    return batched_infidelity(batched, spectrum, omega, contract=contract,
                              escalation_tol=escalation_tol)[0]


def _batched_stat(p: PulseArrays, spectrum: torch.Tensor,
                  omega: torch.Tensor, chunk_size: Optional[int],
                  escalation: str, contract: str,
                  weights: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Infidelities (batch, n_nops) and quantization ratios (batch,) of
    the batch, evaluated in sequential chunks of *chunk_size* pulses
    (*weights*: :func:`_infid_contract`)."""
    batch = p.c_coeffs.shape[0]
    d = p.c_opers.shape[-1]
    if chunk_size is None or chunk_size >= batch:
        chunk_size = batch
    elif chunk_size < 1 or batch % chunk_size:
        raise ValueError(f'chunk_size {chunk_size} must be positive and '
                         f'divide batch {batch}')
    infids, ratios = [], []
    for start in range(0, batch, chunk_size):
        sl = slice(start, start + chunk_size)
        _, terms, degenerate = _prep(p, p.c_coeffs[sl], p.n_coeffs[sl],
                                     p.dt[sl], omega)
        infid, ratio = _infid_contract(terms, spectrum, omega, d,
                                       escalation, contract, degenerate,
                                       weights)
        infids.append(infid)
        ratios.append(ratio)
    return torch.cat(infids), torch.cat(ratios)


def batched_infidelity(p: PulseArrays, spectrum: torch.Tensor,
                       omega: torch.Tensor,
                       chunk_size: Optional[int] = None,
                       contract: Optional[str] = None,
                       escalation_tol: float = config.ESCALATION_TOL
                       ) -> torch.Tensor:
    """Infidelity (batch, n_nops) of a batch of pulses (leading batch
    axis on c_coeffs / n_coeffs / dt; shared operators and basis).

    ``chunk_size`` evaluates the batch in sequential chunks of that many
    pulses, bounding peak memory with no effect on the values; the batch
    must divide evenly into chunks.

    *contract* picks the contraction route (:func:`.config.
    contraction_mode`: 'ozaki' for CUDA tensors, 'native' for CPU ones).
    On the deep factored route every pulse reports its quantization
    statistic (:func:`.numeric._deep_quant_ratio`); when the batch
    maximum exceeds *escalation_tol* the whole batch is recomputed on
    the full-precision route ('force').  Deciding that reads the maximum
    on the host, one synchronization per call.
    """
    mode = config.contraction_mode(p.c_opers.device, contract)
    return _batched_infidelity(p, spectrum, omega, chunk_size, mode,
                               escalation_tol)


def _batched_infidelity(p: PulseArrays, spectrum: torch.Tensor,
                        omega: torch.Tensor, chunk_size: Optional[int],
                        mode: str, escalation_tol: float,
                        weights: Optional[torch.Tensor] = None,
                        ratio_max: Optional[Callable] = None
                        ) -> torch.Tensor:
    """:func:`batched_infidelity` on the resolved route *mode*: the
    'stat' pass, the decision of :func:`.numeric._escalates`, and the 'force'
    pass when it escalates (*weights*: :func:`_infid_contract`)."""
    infid, ratios = _batched_stat(p, spectrum, omega, chunk_size, 'stat',
                                  mode, weights)
    if _escalates(ratios, escalation_tol, ratio_max):
        infid, _ = _batched_stat(p, spectrum, omega, chunk_size, 'force',
                                 mode, weights)
    return infid


def _etm_core(p: PulseArrays, spectrum, omega: torch.Tensor, basis: Basis,
              second_order: bool, budget_bytes: Optional[int] = None
              ) -> torch.Tensor:
    """Error transfer matrices (..., n_b, n_b) of the pulse(s) *p*, with
    any leading batch axes on c_coeffs / n_coeffs / dt: diagonalization,
    per-step control matrices, decay amplitudes, optionally the
    frequency shifts, the cumulant trace contraction and the matrix
    exponential, on the device of the operators.

    A real diagonal spectrum folds S w_trapz / 2 pi into the decay
    amplitudes ('ako,ao,alo->akl') and the frequency shifts
    (:func:`.numeric._second_order_diag_shifts`: the complete steps as
    a running sum over segments that reads the per-step control
    matrices in place, one weighted K2 lattice for each distinct row of
    the spectrum, one for all noise operators where one row serves them
    all), so neither the (a, k, l, w) integrand, F^(2) nor a cumulative
    control matrix exists.  Any other spectrum, a cross-spectrum S_ab
    above all, is read once as real profiles with mixing factors, S_ab
    = sum_r M^(r)_ab s_r (:func:`.numeric._spectrum_profiles`, which
    also checks that it is Hermitian; a spectrum tensor keeps them for
    the next call while it is not written in place): its diagonal takes
    the same route, and the part off it mixes the correlated noise
    operators by M^(r) on one side of the decay amplitudes, of the
    complete steps' running sum and of the incomplete steps, with one
    weighted lattice per profile; no (a, b, k, l, w) integrand, F^(2) or
    lattice per pair exists either.  Each row a of the decay amplitudes
    and shifts then holds the part of its pairs that the cumulant sums.
    The second-order terms run over chunks of segments that fit
    :func:`.config.memory_budget` (*budget_bytes* overrides it).  The
    trace contraction takes the basis's precombined combos for n <= 64
    and runs through the basis above, as the object path's
    (:func:`.numeric._cumulant_contract`).

    Autograd: the result is differentiable in the tensors of the pulse,
    at degenerate spectra too.  The terms that :class:`.numeric._Eigh`
    drops inside degenerate eigenspaces are zero-valued terms with their
    own backward: first order, the control matrix takes
    :func:`.numeric._degenerate_control_matrix`, as the infidelity's
    does; with *second_order* the per-step control matrices take its
    per-step variant before they are summed (the first-order control
    matrix) and accumulated (the complete steps), and the shifts take
    :func:`.numeric._degenerate_incomplete_steps` (the incomplete
    steps, mixed as the forward's).  Both are built only where a
    gradient reaches a degenerate Hamiltonian; the forward values do not
    change.
    """
    with tracing.span('ff.etm'):
        region = tracing.backward_span('ff.etm.backward', *p)
        p = p._make(region.inputs)
        n_nops = p.n_opers.shape[0]
        s = util._broadcast_spectrum(spectrum, omega, np.arange(n_nops),
                                     device=omega.device)
        profiles = None
        if s.ndim <= 2 and not s.is_complex():
            weights = numeric._spectral_weights(s, omega, n_nops)
            # the distinct rows of the weights: one lattice for each
            rows = weights[:numeric._distinct_rows(s)]
        else:
            profiles = numeric._spectrum_profiles(s, omega, n_nops, spectrum)
            rows = profiles.diagonal
            weights = rows.expand(n_nops, -1)
        with tracing.span('ff.prep'):
            prep = tracing.backward_span('ff.prep.backward', p.c_coeffs,
                                         p.n_coeffs, p.dt)
            ham, eigvals, eigvecs, terms = _diagonalized(p, *prep.inputs,
                                                         omega)
            ham, eigvals, eigvecs, *terms = prep.outputs(ham, eigvals,
                                                         eigvecs, *terms)
        with tracing.span('ff.etm.steps'):
            steps = tracing.backward_span('ff.etm.steps.backward', ham,
                                          eigvals, eigvecs, *terms)
            ham, eigvals, eigvecs, *terms = steps.inputs
            _, n_t, b_t, ph, integral = terms
            step = numeric._ctrlmat_step_contract(n_t, integral, b_t, ph)
            degenerate = numeric._degenerate_control_matrix(
                ham, eigvals, eigvecs, terms, omega, p.dt,
                per_step=second_order)
            if second_order and degenerate is not None:
                step = step + degenerate
            ctrl = step.sum(-4)
            if not second_order and degenerate is not None:
                ctrl = ctrl + degenerate
            gamma = numeric._folded_decay_amplitudes(ctrl, weights)
            if profiles is not None:
                gamma = numeric._mixed_decay_amplitudes(ctrl, gamma,
                                                        profiles)
            step, gamma = steps.outputs(step, gamma)
        delta = None
        if second_order:
            incomplete = numeric._degenerate_incomplete_steps(
                ham, eigvals, eigvecs, n_t, b_t, omega, p.dt, rows,
                budget_bytes, profiles)
            shifts = numeric._second_order_diag_shifts(
                eigvals, n_t, b_t, step, omega, p.dt, rows, budget_bytes,
                profiles)
            if incomplete is not None:
                shifts = shifts + incomplete
            delta = shifts.real
        with tracing.span('ff.etm.cumulant'):
            cumulant = tracing.backward_span('ff.etm.cumulant.backward',
                                             gamma, delta)
            k_fn = numeric._cumulant_contract(*cumulant.inputs, basis)
            return region.outputs(cumulant.outputs(
                numeric._expm(k_fn.sum(-3))))


def error_transfer_matrix(p: PulseArrays, spectrum, omega, basis: Basis,
                          second_order: bool = False) -> torch.Tensor:
    """Error transfer matrix exp K (n_b, n_b) of one pulse given as
    :class:`PulseArrays`, for a spectrum of ndim 1-3 (a tensor stays on
    its device); *basis* is the :class:`~.basis.Basis` of ``p.basis``,
    whose four-element traces it contracts with.  The object API
    (:func:`.numeric.error_transfer_matrix`) computes the same quantity
    with caching."""
    omega = torch.as_tensor(omega, dtype=config.REAL,
                            device=p.c_opers.device)
    return _etm_core(p, spectrum, omega, basis, second_order)


def batched_error_transfer_matrix(p: PulseArrays, spectrum, omega,
                                  basis: Basis, second_order: bool = False
                                  ) -> torch.Tensor:
    """Error transfer matrices (batch, n_b, n_b) of a batch of pulses
    (leading batch axis on c_coeffs / n_coeffs / dt; shared operators,
    basis, spectrum and frequencies), evaluated as one batched
    computation; see :func:`error_transfer_matrix`."""
    return error_transfer_matrix(p, spectrum, omega, basis, second_order)
