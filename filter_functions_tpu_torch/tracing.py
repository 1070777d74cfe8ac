"""Spans and counters of the port, for reading a profiled run.

Spans are ``torch.profiler.record_function`` ranges, opened only while
a profiler records (``torch.autograd._profiler_enabled()``); otherwise
:func:`span` and :func:`backward_span` do nothing beyond that check.
Recorded, they are user annotations on the clock of the profiler's
device activities, so a device operation belongs to the span whose host
interval launched it, and a device gap to the span the host was in.  A
span's parent is the span it nests in on the host thread.

==============================  ==============================================
Span                            Where
==============================  ==============================================
``ff.prep``                     :func:`.functional._prep`: the Hamiltonians,
                                the eigendecomposition, the propagators, the
                                step terms and the degenerate-eigenspace term
                                with its check; inside ``ff.etm``, the same
                                without that term
                                (:func:`.functional._diagonalized`)
``ff.prep.backward``            the backward of each ``ff.prep``: ``_Eigh``,
                                the propagators, ``_DegeneratePropagator``
                                and in :func:`.functional._prep`
                                ``_DegenerateControlMatrix``
``ff.etm``                      :func:`.functional._etm_core`: the whole error
                                transfer matrix
``ff.etm.backward``             the backward of ``ff.etm``, from the
                                matrices to the pulse's tensors: the other
                                ETM ranges of the backward nest in it
``ff.spectrum.profiles``        in ``ff.etm``, for a spectrum that is not real
                                and diagonal
                                (:func:`.numeric._spectrum_profiles`): its
                                weighted real profiles and mixing factors,
                                and where the spectrum tensor keeps none yet
                                its one read to the host, Hermitian check and
                                factorization, uploaded
``ff.etm.steps``                in ``ff.etm``: the per-step control matrices
                                (:func:`.numeric._ctrlmat_step_contract`),
                                their degenerate-eigenspace term, their sum
                                and the decay amplitudes
``ff.etm.steps.backward``       the backward of ``ff.etm.steps``: the same
                                with ``_DegenerateStepControlMatrix``
``ff.so.shifts``                :func:`.numeric._second_order_diag_shifts`:
                                the frequency shifts, the complete steps
                                accumulated segment by segment on a running
                                weighted sum (no cumulative control matrix is
                                built) and the chunks of the separable K2
                                tables, whose weighted lattice is built once
                                per distinct spectrum row (once for all noise
                                operators where they share one row), or of a
                                cross-spectrum once per profile
``ff.so.steps``                 in ``ff.so.shifts``, the complete steps
                                (:meth:`.numeric._CompleteStepShifts.
                                forward`): the running ``addcmul`` and the
                                ``baddbmm`` a segment and batch row
``ff.so.tables``                in ``ff.so.shifts``, once a chunk of segments:
                                its weighted K2 lattice
                                (:func:`.numeric._factored_weighted_lattice`),
                                on CUDA the tables kernel of
                                :mod:`.ops.k2_tables` (one launch), its DGEMM
                                and its epilogue, on the CPU the plain tables
``ff.so.sandwich``              in ``ff.so.shifts``, beside ``ff.so.tables``:
                                the noise-basis products once a call, then
                                after each chunk's tables its ``nob_c`` copy,
                                the incomplete steps' products
                                (:func:`.numeric._sandwich`) and their add
                                into the shifts
``ff.so.sandwich.backward``     the backward of each ``ff.so.sandwich``
``ff.so.tables.backward``       :meth:`.numeric._K2Tables.backward`, once a
                                sub-chunk of a chunk's segments (sized to the
                                memory budget, :func:`.numeric._shifts_chunk`):
                                the plain tables rebuilt under autograd and
                                their vector-Jacobian product
``ff.so.degenerate.backward``   :meth:`.numeric._DegenerateIncompleteSteps.
                                backward`: the shifts' part of the derivative
                                inside degenerate eigenspaces, from the slopes
                                of the separable tables
``ff.so.steps.backward``        :meth:`.numeric._CompleteStepShifts.backward`:
                                the gradient of the per-step control matrices
                                through the complete steps' running sum,
                                written once, segment by segment, from a
                                running suffix and the rebuilt running sum
``ff.so.mix``                   in ``ff.etm.steps`` (the decay amplitudes,
                                :func:`.numeric._mixed_decay_amplitudes`), in
                                ``ff.so.steps`` (each update of the running
                                sum), in ``ff.so.sandwich`` (each chunk's
                                incomplete steps) and in
                                ``ff.so.steps.backward`` (each segment of the
                                suffix and of the rebuilt running sum): the
                                correlated noise operators mixed by a
                                cross-spectrum's factors off its diagonal
``ff.so.total``                 :func:`.numeric._second_order_total`: F^(2)
                                of the object path's second-order filter
                                function, the same two parts
``ff.etm.cumulant``             in ``ff.etm``: the cumulant function
                                (:func:`.numeric._cumulant_contract`) and its
                                exponential (:func:`.numeric._expm`)
``ff.etm.cumulant.backward``    the backward of ``ff.etm.cumulant``: the
                                exponential's Taylor and squaring products and
                                the contraction through the basis
``ff.contract``                 :func:`.functional._infid_contract`: the
                                control-matrix contraction (the Ozaki route
                                with ``dword_digits``, the quantization ratio)
                                and the frequency integral
``ff.ozaki.products``           :func:`.ops.ozaki._outer_contract`: the three
                                Gauss products' int8 slice GEMMs and their
                                double-single recombination (on CUDA one
                                launch of the kernel of :mod:`.ops.products`,
                                on the CPU the composite)
==============================  ==============================================

The backward ranges are of two kinds.  Three autograd Functions open
theirs in their own backward (``ff.so.tables.backward``,
``ff.so.degenerate.backward``, ``ff.so.steps.backward``); the other five
mark a region of the forward with :func:`backward_span`, whose markers
open the range when the region's outputs have their gradients and close
it after the region's own nodes.  Both kinds nest only in each other
and run inside the caller's ``torch.autograd.grad``; on CUDA tensors
on a thread of autograd's own, which the profiler records as it does
the caller's.  Besides, autograd opens
``autograd::engine::evaluate_function: <Node>`` around every node
(``_OzakiOuterBackward``, ``_EighBackward``, ...) on the same clock; a
marker's node ends inside the range it opens or closes.

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
from typing import Optional

import torch

__all__ = ['span', 'backward_span', 'BackwardSpan', 'counts', 'decision']

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


class BackwardSpan:
    """A region of the forward whose backward runs inside the profiler
    range *name* (see :func:`backward_span`): :attr:`inputs` are the
    region's inputs to compute with, :meth:`outputs` marks its
    results."""

    __slots__ = ('inputs', '_range', '_close')

    def __init__(self, name: str, inputs: tuple, marked: bool = False):
        self.inputs = inputs
        self._range = self._close = None
        if marked:
            self._range = _Range(name)
            self.inputs = _marked(_Close, (self._range, None), inputs)
            self._close = next(t.grad_fn for t in self.inputs
                               if _tracked(t))

    def outputs(self, *tensors):
        """*tensors* as the region's results: the one tensor, or a tuple
        of several."""
        if self._range is not None and torch.is_grad_enabled():
            tensors = _marked(_Open, (self._range, self._close), tensors)
        return tensors[0] if len(tensors) == 1 else tensors


def backward_span(name: str, *inputs) -> BackwardSpan:
    """Marks a region of the forward so that autograd's work for it runs
    inside the profiler range *name*, on the thread that runs the
    backward.  While a profiler records and grad is enabled, one
    autograd Function over the region's *inputs* that require a
    gradient closes the range in its backward, which runs after the
    region's own nodes, and one over the tensors passed to
    :meth:`BackwardSpan.outputs` opens it in its backward, once their
    gradients are complete; both pass the gradients through and launch
    nothing.  Autograd's engine takes from a device's queue the ready
    node created last, so the nodes of one device run in the reverse
    order of their creation, and the region's nodes between the two
    markers.  Otherwise, or where no input requires a gradient, the
    inputs and outputs are returned as they are, and no autograd node
    is added."""
    if torch.autograd._profiler_enabled() and torch.is_grad_enabled() \
            and any(_tracked(t) for t in inputs):
        return BackwardSpan(name, inputs, marked=True)
    return BackwardSpan(name, inputs)


def _tracked(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


class _Range:
    """The backward range of one region, open between the markers'
    backward calls.  Neither marker refers to the other through it, so
    the graph holds no cycle."""

    __slots__ = ('name', 'handle')

    def __init__(self, name: str):
        self.name = name
        self.handle = None


def _marked(fn, args: tuple, tensors: tuple) -> tuple:
    """*tensors*, those that require a gradient through ``fn(*args,
    ...)``."""
    picked = [i for i, t in enumerate(tensors) if _tracked(t)]
    if not picked:
        return tensors
    out = list(tensors)
    for i, t in zip(picked, fn.apply(*args, *(tensors[i] for i in picked))):
        out[i] = t
    return tuple(out)


class _Marker(torch.autograd.Function):
    """Identity on its tensors (views: nothing launched), gradients
    passed through as they come; *rng* the region's :class:`_Range`,
    *close* the node of its inputs' marker (None in that marker)."""

    @staticmethod
    def forward(ctx, rng, close, *tensors):
        ctx.rng, ctx.close = rng, close
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)


class _Open(_Marker):
    """Over a region's outputs: opens the range, unless the engine skips
    the inputs' marker, which would close it."""

    @staticmethod
    def backward(ctx, *grads):
        if torch._C._will_engine_execute_node(ctx.close):
            ctx.rng.handle = torch.ops.profiler._record_function_enter_new(
                ctx.rng.name, None)
        return (None, None, *grads)


class _Close(_Marker):
    """Over a region's inputs: closes the range where it is open."""

    @staticmethod
    def backward(ctx, *grads):
        handle, ctx.rng.handle = ctx.rng.handle, None
        if handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(handle)
        return (None, None, *grads)
