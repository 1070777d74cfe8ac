"""Spans and counters of the port, for reading a profiled run.

Spans are ``torch.profiler.record_function`` ranges, opened only while
a profiler records (``torch.autograd._profiler_enabled()``); otherwise
:func:`span` does nothing beyond that check.  Recorded, they are user
annotations on the clock of the profiler's device activities, so a
device operation belongs to the span whose host interval launched it,
and a device gap to the span the host was in.  A span's parent is the
span it nests in on the host thread.

==========================  ==================================================
Span                        Where
==========================  ==================================================
``ff.prep``                 :func:`.functional._prep`: the Hamiltonians, the
                            eigendecomposition, the propagators, the step terms
                            and the degenerate-eigenspace term with its check;
                            inside ``ff.etm``, the same without that term
                            (:func:`.functional._diagonalized`)
``ff.etm``                  :func:`.functional._etm_core`: the whole error
                            transfer matrix
``ff.spectrum.profiles``    in ``ff.etm``, for a spectrum that is not real
                            and diagonal (:func:`.numeric._spectrum_profiles`):
                            its weighted real profiles and mixing factors,
                            and where the spectrum tensor keeps none yet
                            its one read to the host, Hermitian check and
                            factorization, uploaded
``ff.etm.steps``            in ``ff.etm``: the per-step control matrices
                            (:func:`.numeric._ctrlmat_step_contract`), their
                            degenerate-eigenspace term, their sum and the
                            decay amplitudes
``ff.so.shifts``            :func:`.numeric._second_order_diag_shifts`: the
                            frequency shifts, the complete steps accumulated
                            segment by segment on a running weighted sum (no
                            cumulative control matrix is built) and the
                            chunks of the separable K2 tables, whose weighted
                            lattice is built once per distinct spectrum row
                            (once for all noise operators where they share
                            one row), or of a cross-spectrum once per profile
``ff.so.tables``            in ``ff.so.shifts``, once a chunk of segments:
                            its weighted K2 lattice
                            (:func:`.numeric._factored_weighted_lattice`), on
                            CUDA the tables kernel of :mod:`.ops.k2_tables`
                            (one launch), its DGEMM and its epilogue, on the
                            CPU the plain tables
``ff.so.tables.backward``   :meth:`.numeric._K2Tables.backward`, once a
                            sub-chunk of a chunk's segments (sized to the
                            memory budget, :func:`.numeric._shifts_chunk`):
                            the plain tables rebuilt under autograd and
                            their vector-Jacobian product; on autograd's
                            thread
``ff.so.degenerate.backward``  :meth:`.numeric._DegenerateIncompleteSteps.
                            backward`: the shifts' part of the derivative
                            inside degenerate eigenspaces, from the slopes
                            of the separable tables; on autograd's thread
``ff.so.steps.backward``    :meth:`.numeric._CompleteStepShifts.backward`:
                            the gradient of the per-step control matrices
                            through the complete steps' running sum,
                            written once, segment by segment, from a
                            running suffix and the rebuilt running sum;
                            on autograd's thread
``ff.so.mix``               in ``ff.etm.steps`` (the decay amplitudes,
                            :func:`.numeric._mixed_decay_amplitudes`), in
                            ``ff.so.shifts`` (each update of the running sum,
                            each chunk's incomplete steps) and in
                            ``ff.so.steps.backward`` (each segment of the
                            suffix and of the rebuilt running sum): the
                            correlated noise operators mixed by a
                            cross-spectrum's factors off its diagonal
``ff.so.total``             :func:`.numeric._second_order_total`: F^(2) of
                            the object path's second-order filter function,
                            the same two parts
``ff.etm.cumulant``         in ``ff.etm``: the cumulant function
                            (:func:`.numeric._cumulant_contract`) and its
                            exponential (:func:`.numeric._expm`)
``ff.contract``             :func:`.functional._infid_contract`: the
                            control-matrix contraction (the Ozaki route with
                            ``dword_digits``, the quantization ratio) and the
                            frequency integral
``ff.ozaki.products``       :func:`.ops.ozaki._outer_contract`: the three Gauss
                            products' int8 slice GEMMs and their double-single
                            recombination (on CUDA one launch of the kernel of
                            :mod:`.ops.products`, on the CPU the composite)
==========================  ==================================================

The backward has spans of its own only in the three ``*.backward``
rows above.  Besides, autograd opens
``autograd::engine::evaluate_function: <Node>`` around every node
(``_OzakiOuterBackward``, ``_EighBackward``, ...) on the same clock.
On CUDA tensors the backward runs on a thread of autograd's own, which
the profiler records as it does the caller's.

:data:`counts` counts the host's reads of the device and the escalation
decisions, each at the site that makes it, after the value is on the
host, and the work of the slice products; clear it with
``counts.clear()``.

=========================  ==============================================
Counter                    Incremented by
=========================  ==============================================
``sync.escalation``        :func:`.numeric._escalates` reading the
                           largest quantization ratio of a batch
                           (:mod:`.functional`) or of a chunk of segments
                           (:func:`.numeric.
                           calculate_control_matrix_from_scratch`)
``sync.degenerate``        :func:`.numeric._reaches_degenerate` reading
                           whether an eigenspace is degenerate
``sync.expm``              :func:`.numeric._expm` reading the norm
``sync.spectrum``          :func:`.numeric._factor_spectrum` reading a
                           spectrum that is not real and diagonal (once
                           per spectrum tensor not written since), and
                           :func:`.util.parse_spectrum` checking that a
                           3-d spectrum is Hermitian
``escalation.decisions``   each decision of :func:`.numeric._escalates`
``escalation.escalated``   each decision that recomputes at full
                           precision
``ozaki.int8_ops``         :func:`.ops.ozaki._outer_contract`, by the
                           int8 operations of its slice products,
                           3 B sum_pairs 2 M K N (unpadded, on every
                           device)
``so.tables.recomputed``  :meth:`.numeric._K2Tables.backward`, by the
                           segments whose plain tables it rebuilt, each
                           leading (batch) index counted
``so.steps.differentiated``  :meth:`.numeric._CompleteStepShifts.
                           backward`, by the segments whose gradient it
                           wrote, each leading (batch) index counted
=========================  ==============================================

The port's other counters stay in their modules:
:data:`.ops.dword.launches`, :data:`.ops.products.launches` and
:data:`.ops.k2_tables.launches` (launches of the three CUDA kernels; the
last once a chunk of the second-order shifts on CUDA) and
:data:`.parallel.sharding.collectives` (collectives of the sharded entry
points).
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch

__all__ = ['span', 'counts', 'decision']

#: The counters of the table above, by name.
counts: Counter = Counter()

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named *name* while a profiler records, else a
    context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def decision(escalated: bool) -> bool:
    """Counts an escalation decision and returns it."""
    counts['escalation.decisions'] += 1
    if escalated:
        counts['escalation.escalated'] += 1
    return escalated
