"""Smoke run of the PyTorch port (filter_functions_tpu_torch) on one CUDA
card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. card: a CUDA card must be present; prints its name and power limit.
2. build: compiles the CUDA kernel from ``csrc/`` and prints nvcc's
   register / shared-memory / spill report.
3. kernel: ``dword_digits`` on the card against its plain PyTorch
   version on the card, bit-exact, at the seven shapes of
   ``KERNEL_SHAPES``: K, J, C, n_d = 512, 3, 128, 4; the flagship's 3328,
   18, 256, 5 (batch 2, as the main path calls it); a ragged K = 333
   (byte stores); K = 20000, above the kernel's register cap; the
   flagship at batch 1 (the object path's call, phases 6, 7a, 9a, 9b);
   K = 13312 at batch 1 (phase 9c's 52-segment pulse from scratch: the
   instance that keeps two runs of words a thread); K = 3328, J = 3 at
   batch 1 (phase 10a's crosstalk rows).  Times the
   flagship call of both beside its memory bound and the card's name and
   power limit.
4. main path: ``functional.batched_infidelity`` on the 4-qubit QFT pulse
   at 1000 frequencies, batch 32 in chunks of 2 (bench.py's flagship
   inputs), through the default CUDA route (the factored Ozaki route).
   Checks that the kernel launched, that every value is finite, that
   the escalation statistic stays below its threshold, that row 0 is
   within 1e-10 of the native complex128 route on the card, and that
   the card's native row 0 is within 1e-12 of the CPU's.
5. timing: median of 5 runs of both routes, in ms per pulse.
6. object path: ``fft.infidelity`` on the QFT pulse built with
   ``PulseSequence.from_arrays`` on the card, at 1000 frequencies,
   through the default CUDA route.  Checks that the kernel launched,
   that the (18,) result is finite, within 1e-10 of phase 4's native
   row 0 and within 1e-12 of its Ozaki row 0, that a second call with
   the same frequencies launches nothing, and that the filter function
   is (18, 18, 1000) complex128; times 5 cold calls (caches cleared),
   median in ms, and reports the peak device memory of the phase.
7. error transfer matrix.
   a. ``fft.error_transfer_matrix`` of the QFT pulse on the card, first
      order, 1000 frequencies, through the default CUDA route: the
      control matrix launches the kernel, the 256-element basis takes
      the contraction through the basis.  Checks that the kernel
      launched, that the (256, 256) float64 result is finite and
      completely positive, that -tr K / d^2 of its cumulant function is
      within 1e-12 relative of phase 6's infidelity sum, that it is
      within 1.6e-9 of the ETM from a natively computed control matrix,
      and that the card's native ETM is within 1e-12 of the CPU's;
      times 5 cold calls (each must launch the kernel), median in ms,
      and reports the peak device memory.
   b. ``functional.batched_error_transfer_matrix(..., second_order=True)``
      at bench.py's ``config_second_order`` inputs (d = 4, 8 segments,
      2 control and 2 noise operators, 200 frequencies, batch 64, GGM
      basis, ``default_rng(7)``, spectrum 1e-4/omega).  Checks the
      (64, 16, 16) shape, rows 0 and 63 within 1e-13 of the object
      path's second-order ETM on the card, the antisymmetry of the
      second-order part of row 0's cumulant function within 1e-15, and
      rows 0 and 63 within 1e-12 of the CPU; times 5 calls, median in ms
      per evaluation.
   c. The second-order term from the separable tables of the K2
      lattice (the port's only from-scratch route) against the
      (n_omega, d^4) lattice it replaces, each call timed as the median
      of 5 with the peak device memory of those calls; no kernel
      launches (the count is checked unchanged).  (i) 7b's inputs: the
      batched ETM for 1e-4/omega and for a real cross-spectrum (2, 2,
      200) of 1e-4/omega on the diagonal and 0.5e-4/omega off it (F^(2),
      not the folded shifts); rows 0 and 63 of each within 1e-13 of the
      object path's ETM on the cached lattice
      (``cache_filter_function(order=2, cache_intermediates=True)``).
      (ii) The 3-qubit QFT pulse at full width
      (``qft.qft_pulse_arrays(3)``: d = 8, 10 segments, 12 + 12
      operators, 64-element GGM basis), 1000 frequencies in
      geomspace(1e-2, 1e2), S = 1e-4/omega, batch 8 with rows 1-7 scaled
      as the flagship batch: the batched second-order ETM, finite (64
      elements: the widest basis contracted with the dense trace combos;
      above it the ETM contracts through the basis).  (iii) The
      flagship's frequency shifts (row 0 of phase 4's inputs, d = 16,
      1000 frequencies): ``numeric._second_order_diag_shifts`` on the
      step terms that ``functional._etm_core`` builds, finite; the
      lattice holds 1.05 GB per segment.  At each of (i)-(iii) the
      frequency-reduced term of the shifts from the tables against
      weights @ the K2 lattice (``reduced_term``), within 1e-13 (i) and
      1e-12 (ii, iii) of its largest entry.  Neither package runs the
      flagship's second-order ETM under a cross-spectrum: F^(2) would be
      (18, 18, 256, 256, 1000) complex128, about 340 GB.
   d. Autograd through the flagship's first-order
      ``functional.error_transfer_matrix`` (row 0, 1000 frequencies,
      S = 1e-4/omega, the 256-element basis contracted through the
      basis): the directional derivative of its sum weighted by
      ``default_rng(14)`` normals, along a direction from the same
      generator in c_coeffs, within 1e-6 relative of central differences
      at h = 1e-6; the flagship is degenerate on segments 0-2, and the
      derivative without the degenerate-eigenspace term is printed
      beside it.  The same for the second-order ETM (the folded shifts):
      within 1e-6 relative of central differences, printed beside the
      derivative without the degenerate-eigenspace terms of the per-step
      control matrices and of the incomplete steps.  No kernel launch
      (the ETM contracts each segment in complex128); times forward plus
      backward of each order, with the peak memory.
8. gradients.
   a. ``torch.autograd.grad`` of the summed ``functional.
      batched_infidelity`` of phase 4's rows 0-3 (chunks of 2, 1000
      frequencies) with respect to the control coefficients, through the
      default CUDA route: the forward pass must launch the kernel once
      per chunk and the backward pass not at all.  Checks that the
      gradient is finite, within 1e-5 (relative to its largest entry) of
      the native route's gradient on the card, and that the card's
      native row 0 is within 1e-10 relative of the CPU's; times forward
      plus backward of both routes, median of 5, in ms per pulse, and
      reports the peak device memory.
   b. ``fft.infidelity_derivative`` (the analytic derivative) of the QFT
      pulse on the card at 200 frequencies: summed over the noise
      operators it must be within 1e-9 (relative to the largest entry)
      of the native autograd gradient at the same frequencies.  Prints
      how many eigenvalue pairs of the card's diagonalization are
      nearly but not exactly degenerate, times 3 cold calls (median)
      and reports the peak device memory.
   c. bench.py's ``config_grad`` inputs (d = 2, X/2 and Y/2 controls,
      Z/2 noise, 8 segments, batch 256, 200 frequencies, S = 1e-3/omega,
      ``default_rng(3)``): autograd of ``batched_infidelity``, median of
      5 in ms per pulse; row 0 within 1e-12 absolute of the analytic
      derivative summed over the noise operators.

9. concatenation in time (``fft.concatenate``, ``concatenate_periodic``,
   ``a @ b``: the composed pulse's filter function from the cached control
   matrices of its parts), with the kernel's launches counted per part.
   a. The live flagship: ``models.qft.qft_pulse(4)`` on the card equals
      ``qft_pulse_sequence(4)``'s five arrays exactly.  Its 9 gates with
      filter functions cached at phase 4's 1000 frequencies compose with
      0 kernel launches (no gate is deep); the composed control matrix is
      within 1e-12 (of its largest entry) of the native from-scratch one,
      its infidelity within 1e-10 of phase 6's, and the default-route
      from-scratch call launches the kernel once.  Times the cold
      composition (build the gates, cache, concatenate), median of 5.
   b. A periodic train of the flagship, its control matrix cached through
      the default route (1 launch): at 16 repeats ``concatenate_periodic``
      equals ``concatenate([qft] * 16)``, is within 1e-11 of K5 on 16
      copies and within 1e-5 (the deep route's operand quantization) of
      the 208-segment pulse from scratch; at 10^4 repeats the closed form
      is finite with a total propagator unitary to 1e-10; timed, with its
      peak memory.
   c. Four distinct flagship-sized gates (rows 0-3 of phase 4's batch as
      ``PulseSequence``s), control matrices cached through the default
      route (4 launches), concatenated with the pulse-correlation filter
      function: it sums to the total one; the total control matrix is
      within 1e-5 of the 52-segment pulse's from scratch (default route,
      one launch per segment chunk) and, from natively cached parts,
      within 1e-12 of the CPU's; timed.
   d. bench.py's small-d configurations at their published sizes, parity
      and one timing each: ``concat_train`` (10^4 cached NOT pulses, 400
      frequencies, against ``concatenate_periodic``, and the general path
      on two alternating objects), ``clifford_train`` (24 distinct pulses
      of 1-3 segments at 10^4 positions, ``default_rng(11)``, against the
      CPU), ``dd`` (CPMG-16 and UDD-16 at 400 frequencies against the
      closed forms; batch 1024), ``rb`` (1024 sequences of 20 Cliffords
      plus recovery at 301 frequencies, ``default_rng(0)``, against
      ``rb_pulse`` by ``concatenate`` on four of them).
   e. Second order: rows 0 and 1 of phase 7b's inputs as objects,
      concatenated with ``calc_second_order_FF``: within 1e-12 of the
      16-segment pulse's second-order filter function from scratch.

10. composition in space, spectroscopy and the exchange model.
   a. ``fft.extend`` at the flagship's width: two d = 4 parts (13
      segments of the flagship's durations, Pauli basis, X and Y controls
      on both qubits and an (XX + YY)/4 exchange, amplitudes from
      ``default_rng(8)``; X, Y, Z noise on both qubits) with filter
      functions cached at phase 4's 1000 frequencies (0 launches: K =
      208) are mapped to qubits (0, 2) and (3, 1) (the second remapped
      inside extend) with three crosstalk operators Z_i Z_{i+1}/4 + Z_i/2
      on the pairs (0, 1), (1, 2), (2, 3) as additional noise: N = 4, d =
      16, 256 Pauli elements, 15 noise operators; the crosstalk rows
      come from scratch on the default route (K = 3328: 1 launch).
      Checks the operators, identifiers and coefficients against the
      explicitly built register pulse (exactly), its total propagator
      (1e-12), the parts' control-matrix rows against its native ones
      (1e-12 of the largest entry), the crosstalk rows (1e-5), the cached
      filter function against B^H B of the cached control matrix (1e-14)
      and against the explicit pulse's, cross blocks included (1e-5), the
      infidelity under a spectrum that correlates each crosstalk operator
      with its Z row (1e-10), and the card against the CPU with the
      crosstalk rows native (1e-12); times 5 cold extends beside the
      explicit pulse's cold control matrix, with the peak memory.
   b. ``fft.remap`` of 10a's pulse to qubit order (2, 0, 3, 1): the
      cached control matrix is the index permutation of 10a's
      (``torch.equal``), the operators are ``tensor_transpose`` of 10a's,
      and the remapped pulse's native control matrix from scratch agrees
      (1e-12 on the parts' rows, 1e-5 on the crosstalk rows); 0
      launches; timed.
   c. Spectroscopy: CPMG-8 at 1024 durations in geomspace(0.3, 30)
      (``models.dd``, Z/2 noise), fidelity filter functions at 400
      frequencies in geomspace(0.2, 200) through
      ``functional.fidelity_filter_function``; ``design_matrix`` with 12
      nodes and ``reconstruct`` of 1e-3/nodes^0.7 (ridge 1e-10, 2000
      steps).  Checks A s against ``fft.infidelity`` of the interpolated
      spectrum on 8 pulses (1e-10 relative), s >= 0, the forward residual
      (1e-3), the interior nodes (0.15) and the card against the CPU
      (``S_HAT_PARITY``); times both.
   d. ``models.exchange``: ``heisenberg_operators(4)`` and ``cnot_pulse``
      on a .mat file of the published file's fields and shapes, written
      to a temporary directory from ``default_rng(9)`` (n_dt =
      ``CNOT_SEGMENTS``; not the published pulse): its infidelity in
      ``qubit_subspace_basis()`` under the Dial spectrum within 1e-12
      relative of the CPU port's; prints the launches.

11. the sharded paths (``parallel``) on the card.
   a. ``parallel.make_mesh(1)`` creates a process group of one ('nccl',
      which then never reduces) and a 1 x 1 mesh on cuda:0;
      ``sharded_batched_infidelity`` of phase 4's inputs (batch 32,
      chunks of 2, 1000 frequencies) equals phase 4's result
      (``torch.equal``) with no collective and 16 kernel launches; timed
      beside ``functional.batched_infidelity`` in ms/pulse.
   b. Two ranks on cuda:0, spawned, on 'gloo' with a ``FileStore`` in a
      temporary directory (NCCL refuses two ranks on one card): rows 0-3
      of phase 4's batch at 1000 frequencies on a 1 x 2 mesh (frequencies
      split) and a 2 x 1 mesh (batch split).  gloo all-reduces CUDA
      tensors but crashes on their all-gather, so a rank gathers a result
      as ``full_tensor()`` of its placements on a CPU mesh of the same
      ranks.  ``.full_tensor()`` of
      ``sharded_batched_infidelity`` within 1e-12 relative of phase 4's
      rows, ``sharded_filter_function`` of row 0 within 1e-13 (of its
      largest entry; predicted equal) of the unsharded filter function,
      the collective lists and each rank's launches as
      ``parallel.sharding`` documents them, and
      ``__graft_entry__.dryrun_multichip``'s problem (d = 2, 3 segments,
      batch 4, 4 frequencies) on a 2 x 1 mesh: ``grape_step``'s loss
      finite and falling over two steps, ``sharded_batched_infidelity``
      finite.  Autograd on both meshes: the sum of each rank's rows of
      ``sharded_batched_infidelity`` of rows 0-3 (8a's loss),
      ``.to_local()`` and ``.backward()``: the rank's rows of the
      c_coeffs gradient within 1e-10 relative of phase 8a's, zero
      elsewhere, with the forward collectives of the call without
      gradients and one SUM over 'omega' in the backward pass on 1 x 2,
      none on 2 x 1, and no kernel launch in the backward pass.  Both
      ranks must exit 0 within ``RANK_DEADLINE``
      (``parallel.ranks.run_ranks``).
   c. GRAPE on the one-rank mesh: the dryrun problem for one rank (batch
      2), loss finite and falling; on rows 0-3 of phase 4's batch
      (chunks of 2, default route) ``grape_step``'s gradient within
      1e-10 relative of phase 8a's autograd gradient, with 2 launches;
      ``optimize_pulse`` for 5 steps, finite, with its launches; times a
      GRAPE step in ms per pulse, with its peak device memory.

12. the entry points (``filter_functions_tpu_torch.entry``) and the
    escalation.
   a. ``entry()`` on the card: ``fn(*args)`` is (18,) float64, within
      1e-12 relative of phase 4's Ozaki row 0 and 1e-10 of its native
      row 0, with exactly one kernel launch per call; times 5 calls,
      median in ms, with the peak memory.
   b. ``entry.dryrun_multichip(2)``'s rank function,
      ``entry._dryrun_rank(2, 'cuda')``, in phase 11b's two ranks (a spawn
      of its own would add 18-32 s to the run): each rank's mesh and
      coordinate, its loss and block of infidelities within 1e-12
      relative of 11b's dryrun on the same 2 x 1 mesh, no kernel launch
      (K = 12 is not deep), counted in the rank; prints its seconds.
   c. The CPMG-300 train (tests/test_torch_accuracy_policy.py: d = 2, 601
      segments, K = 2404, 100 frequencies in geomspace(1e-4, 1e2),
      S = 1e-3/omega^2) on the default route, through
      ``batched_infidelity`` (a batch of the train and a 1e-7
      perturbation of it) and through ``get_filter_function``: one
      kernel launch each in the fast 'stat' pass, a statistic above
      ``config.ESCALATION_TOL``, the escalated results within 1e-12
      relative of the card's native route (elementwise for the filter
      function) and of the CPU's (relative to the largest entry: at the
      refocusing points two summation orders differ elementwise by ~eps
      1e11; the card's native against the CPU's native, elementwise, is
      printed as the witness), the unescalated distance beside them;
      times the escalated, unescalated and native batched calls in 21
      turns (median and quartiles) and the cold object call.

13. the examples (``examples_torch/``, the counterparts of ``examples/``):
    each ``main([..., '--device', 'cuda'])`` in process at its default
    size (``qft``: the flagship on the object path at 500 frequencies, a
    cold control matrix at K = 3328 that launches the kernel;
    ``randomized_benchmarking``: 24 Cliffords, lengths 1 2 5 10 20, 10
    samples, 301 frequencies; ``periodic_driving``: 10^4 repeats at 400
    frequencies; ``optimal_control``: 300 GRAPE steps of 8 candidates, 16
    segments, 200 frequencies; the others at theirs); prints its lines,
    its numbers, its ms and its kernel launches.  Checks each example's
    invariants (the Hadamard and QFT equivalences, complete positivity
    and the Gamma-trace identity, the cache flags and the Sigma_gg'
    identity of the pulse-correlation filter functions, remap's
    invariance, GRAPE lowering the infidelity), its diagnostics below the
    tests' bounds (cached against from scratch 1e-10, periodic against
    standard 1e-10, extended against explicit 1e-13, analytic against
    autograd 1e-12), that ``qft`` launches the kernel, and every number of
    all but ``periodic_driving`` and ``optimal_control`` against the
    port's CPU run of the same example within 1e-10 relative
    (``example_on_card`` lists the exceptions).

After phases 3, 5, 6, 7a, 7b, 7c, 7d, 8, 9, 10, 11 (with 12b), 12a, 12c and
13 a line ``phase time:``
gives the host-clock seconds since the one before.  Before the last line
come the card's label and the kernels' JSON record, in that order; the
last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import copy
import functools
import importlib.util
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed

import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import (analytic, basis, config, convert,
                                        entry, functional, numeric, parallel,
                                        spectroscopy, superoperator, util)
from filter_functions_tpu_torch.models import dd, exchange, qft, rb
from filter_functions_tpu_torch.ops import _build, dword
from filter_functions_tpu_torch.parallel import ranks as parallel_ranks
from filter_functions_tpu_torch.parallel import sharding

N_OMEGA = 1000
BATCH = 32
CHUNK = 2
N_TIMED = 5
#: dword_digits shapes: (K, J, C, n_d, slice_bits, batch).
KERNEL_SHAPES = {'small': (512, 3, 128, 4, 7, 1),
                 'flagship': (3328, 18, 256, 5, 7, CHUNK),
                 'ragged': (333, 2, 9, 5, 7, 3),
                 'above_cap': (20000, 2, 16, 5, 7, 1),
                 'flagship_one': (3328, 18, 256, 5, 7, 1),
                 'deep_train': (13312, 18, 256, 5, 7, 1),
                 'extend_extra': (3328, 3, 256, 5, 7, 1)}
#: The H100 SXM's device-memory rate (NVIDIA's data sheet), bytes/s.
#: There is no published int32 rate, so a kernel's bound here is its
#: memory floor.
HBM_BYTES_PER_S = 3.35e12
#: BASELINE.json's infidelity parity contract, held by the Ozaki route
#: against the native one.
PARITY = 1e-10
#: The card's native route against the CPU's: both are complex128
#: products, summed in another order.
CPU_PARITY = 1e-12
#: The object path's Ozaki route against the functional one's on the
#: same card: the same digits and recombination, from an
#: eigendecomposition of another batch shape.
OBJECT_PARITY = 1e-12
#: The Ozaki route's ETM against the native route's: d times PARITY,
#: since sum_k Gamma_kk = d I_a carries the infidelity's error into K.
ETM_PARITY = 1.6e-9
#: -tr K / d^2 against the infidelity, relative: the same control
#: matrix, integrated with trapezoid weights instead of the trapezoid.
TRACE_IDENTITY = 1e-12
#: The batched second-order ETM against the object path's, as the JAX
#: package holds its own (tests/test_parallel.py).
ETM_BATCH_PARITY = 1e-13
#: Antisymmetry of the second-order part of the cumulant function.
ANTISYMMETRY = 1e-15
#: config_second_order's shapes: (d, segments, frequencies, batch).
SO_SHAPE = (4, 8, 200, 64)
#: 7c at 7b's inputs: the ETM rows from the separable tables against
#: the object path's on the cached K2 lattice, and the frequency-reduced
#: term against the lattice's relative to its largest entry.
LATTICE_PARITY = 1e-13
#: The frequency-reduced term at the 3-qubit QFT pulse and the
#: flagship's, relative to its largest entry.
WIDE_LATTICE_PARITY = 1e-12
#: Lattice-size complex128 arrays per segment that the K2 lattice build
#: holds at once (up to four inside it, the result and its frequency
#: reduction): the chunks of 7c's plain version are counted with it.
LATTICE_TEMPS = 6
#: The 3-qubit QFT batch of 7c(ii): (qubits, frequencies, batch).
QFT3_SHAPE = (3, 1000, 8)
#: 7d: the step of the central differences along a seeded direction in
#: the flagship's control coefficients, and the bound on autograd's
#: directional derivative of the weighted first-order ETM against them,
#: relative (a CPU run of the same inputs: 7.3e-8 apart).
ETM_GRAD_STEP = 1e-6
ETM_GRAD_PARITY = 1e-6
#: Pulses and chunk size of the flagship autograd (8a): every chunk's
#: graph stays alive until the backward pass.
GRAD_BATCH = 4
#: The Ozaki route's gradient against the native route's, relative to the
#: largest entry: its backward returns the gradient of the split-float32
#: operand P in float32, as the JAX package's
#: (tests/test_gradient.py::test_jax_grad_through_deep_factored_contraction).
GRAD_PARITY = 1e-5
#: The card's native gradient against the CPU's, relative.
GRAD_CPU_PARITY = 1e-10
#: Frequencies of the analytic flagship derivative (8b): one (n_ctrl,
#: n_w, G, n_nops, d^2) complex128 array is 3.45 GB there.
N_OMEGA_ANALYTIC = 200
#: The analytic derivative against autograd, relative to the largest
#: entry.
ANALYTIC_PARITY = 1e-9
#: config_grad's row 0 against the analytic derivative, absolute
#: (BASELINE.json records 1.32e-14 for the JAX package).
GRAD_CONFIG_PARITY = 1e-12
#: config_grad's shapes: (segments, frequencies, batch).
GRAD_SHAPE = (8, 200, 256)
#: A composed control matrix or filter function against the from-scratch
#: one, both native complex128, relative to the largest entry.
CONCAT_PARITY = 1e-12
#: The periodic closed form against K5 on copies: the same atomic matrix
#: through two sums of 16 terms.
PERIODIC_PARITY = 1e-11
#: Control matrices that went through the deep factored route against
#: native ones, relative to the largest entry: the route quantizes its
#: operands to 2^-21 (numeric._deep_quant_ratio), and a sum over parts
#: keeps that level.
OZAKI_CTRL_PARITY = 1e-5
#: Unitarity of the total propagator of a 10^4-fold train.
UNITARITY = 1e-10
#: Repeats of the flagship's periodic trains (9b).
TRAIN_REPEATS = (16, 10_000)
#: The long d = 2 trains (9d): the general path against the closed form,
#: and the card against the CPU.
LONG_TRAIN_PARITY = 1e-8
CLIFFORD_TRAIN_PARITY = 1e-9
#: dd's filter functions against the closed forms, absolute, as the JAX
#: package's tests hold them.
DD_PARITY = 1e-10
#: (pulses, frequencies) of concat_train and clifford_train; (order,
#: frequencies, batch) of dd; (sequences, length, frequencies) of rb.
TRAIN_SHAPE = (10_000, 400)
DD_SHAPE = (16, 400, 1024)
RB_SHAPE = (1024, 20, 301)
#: extend's cached filter function against B^H B of its cached control
#: matrix, relative: the same product.
FF_IDENTITY = 1e-14
#: The spectroscopy family (10c): (pulses, frequencies, nodes, steps).
SPECTRO_SHAPE = (1024, 400, 12, 2000)
#: The card's reconstruction against the CPU port's, relative to the
#: largest node value: A^T A at ridge 1e-10 has condition number ~1e10,
#: so two SVDs of the least-squares start differ by up to cond * eps
#: ~2e-6 along its smallest singular vector, which the steps hardly move
#: (tests/test_torch_spectroscopy.py holds the port to JAX by the same
#: bound).
S_HAT_PARITY = 1e-5
#: Segments of the .mat file of 10d: K = 36 n_dt = 18 000 is above the
#: deep regime, so the card runs the native route and holds the CPU's
#: infidelity to 1e-12.
CNOT_SEGMENTS = 500
#: The sharded infidelity against the unsharded one, relative: the
#: frequency integral summed in another order (trapezoid weights), as
#: the JAX package holds its own (tests/test_parallel.py).
SHARD_PARITY = 1e-12
#: The frequency-sharded filter function against the unsharded one,
#: relative to its largest entry.  Predicted equal: the deep route scales
#: each frequency row of P by its own power of two.
SHARD_FF_PARITY = 1e-13
#: Seconds the two ranks of phase 11b may take, start-up included.
RANK_DEADLINE = 600
#: grape_step's gradient against phase 8a's autograd gradient, relative.
GRAPE_PARITY = 1e-10
#: A rank's rows of the sharded infidelities' autograd gradient (11b)
#: against phase 8a's, relative: the frequency integral and its backward
#: summed in another order.
SHARD_GRAD_PARITY = 1e-10
#: The learning rate of the gradient probe (11c): a power of two, so
#: that (c - new) / lr gives the gradient back to its own rounding.
GRAPE_PROBE_LR = 2.0**20
#: Steps of optimize_pulse on the flagship rows (11c).
OPTIMIZE_STEPS = 5
#: 12c: the escalated CPMG-300 results against the native route's on the
#: card and on the CPU, relative (the rerun is the native route).
ESCALATED_PARITY = 1e-12
#: 12c: rounds of the escalated, unescalated and native calls timed in
#: turns: the escalation's cost (the native rerun) is smaller than the
#: spread of one call's host time between runs (PERF.md, phase 12c).
ESCALATION_ROUNDS = 21
#: Phase 13: the examples of examples_torch/, run in this order at their
#: default sizes; those in EXAMPLE_FIGURES take ``--out``.
EXAMPLES = ('getting_started', 'qft', 'calculating_quantum_processes',
            'advanced_concatenation', 'periodic_driving', 'extending_pulses',
            'randomized_benchmarking', 'optimal_control',
            'noise_spectroscopy', 'qutip_integration')
EXAMPLE_FIGURES = {'qft', 'noise_spectroscopy', 'qutip_integration'}
#: 13: an example's numbers on the card against the port's CPU run of
#: the same example, relative (tests/test_torch_examples*.py's bound of
#: the port against the JAX package); the exceptions are in
#: ``example_on_card``.
EXAMPLE_PARITY = 1e-10
#: 13: the diagnostic "max |diff|" numbers of the examples and their
#: bounds (the tests' bounds).
EXAMPLE_DIAGNOSTICS = {'cached_vs_scratch': 1e-10,
                       'periodic_vs_standard': 1e-10,
                       'extended_vs_explicit': 1e-13,
                       'gradient_rel_diff': 1e-12}


def _card_label() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _cuda_ms(fn, runs: int) -> float:
    """Mean time of *fn* on the card, from CUDA events, after a warm-up
    run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / runs


def _median_ms(fn, runs: int) -> float:
    """Median host time of *fn*, ending in a synchronization, in ms."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _in_turns_ms(calls: dict, rounds: int) -> dict:
    """(median, first and third quartile) of the host time of each of
    *calls* in ms, each ending in a synchronization, run in turns (one of
    each per round) so that the host's drift reaches all of them alike."""
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (statistics.median(t), *statistics.quantiles(t, n=4)[::2])
            for name, t in times.items()}


def dword_bound_ms(K, J, C, n_d, batch) -> float:
    """Memory floor of one dword_digits call: the int32 factors read
    once, the int8 digits and int32 shifts written once."""
    reads = batch * K * 2 * (J + C) * 4
    writes = batch * 3 * J * C * (n_d * K + 4)
    return (reads + writes) / HBM_BYTES_PER_S * 1e3


def check_kernel(device, card):
    """Phase 3: kernel against plain version, bit-exact; returns the
    flagship shape's (max_abs_err, kernel ms, plain ms, bound ms)."""
    result = None
    for name, (K, J, C, n_d, sb, batch) in KERNEL_SHAPES.items():
        rng = np.random.default_rng(7)
        factors = [torch.from_numpy(rng.integers(
            -2**23, 2**23, (batch, K, n), dtype=np.int32)).to(device)
            for n in (J, J, C, C)]
        digits, shifts = dword.dword_digits(*factors, n_d, sb)
        torch.cuda.synchronize()
        want_d, want_s = dword.dword_digits_reference(*factors, n_d, sb)
        want_d = want_d.transpose(-1, -2)
        err = max((digits.int() - want_d.int()).abs().max().item(),
                  (shifts - want_s).abs().max().item())
        if err != 0 or not torch.equal(digits, want_d):
            raise AssertionError(f'dword_digits {name}: kernel differs from '
                                 f'its plain version (max |diff| {err})')
        print(f'kernel {name} K={K} J={J} C={C} n_d={n_d} batch={batch}: '
              f'bit-exact against the plain version (tolerance 0)')
        if name in ('flagship', 'extend_extra'):
            ms = _cuda_ms(lambda: dword.dword_digits(*factors, n_d, sb), 20)
            plain_ms = _cuda_ms(lambda: dword.dword_digits_reference(
                *factors, n_d, sb), 5)
            bound_ms = dword_bound_ms(K, J, C, n_d, batch)
            print(f'kernel {name}: dword_digits {ms:.4f} ms, plain '
                  f'version {plain_ms:.4f} ms per call of {batch} pulses; '
                  f'memory bound {bound_ms:.4f} ms, '
                  f'{100 * bound_ms / ms:.1f} % of it [{card}]')
            if name == 'flagship':
                result = (err, ms, plain_ms, bound_ms)
    return result


def _jittered(p, batch):
    """*batch* copies of the pulse *p*: row 0 as it is, the other rows
    with control coefficients scaled by 1 + 0.05 N(0, 1) from
    default_rng(0), as bench.py's flagship batch."""
    rng = np.random.default_rng(0)
    scales = 1 + 0.05 * rng.standard_normal((batch, 1, 1))
    scales[0] = 1.0
    return p._replace(
        c_coeffs=p.c_coeffs[None] * torch.from_numpy(scales).to(
            p.c_coeffs.device),
        n_coeffs=p.n_coeffs.expand(batch, -1, -1).contiguous(),
        dt=p.dt.expand(batch, -1).contiguous())


def flagship_inputs(device):
    """bench.py's flagship batch: the QFT pulse in row 0, rows 1-31
    jittered (:func:`_jittered`)."""
    batched = _jittered(qft.qft_pulse_arrays(4, device=device), BATCH)
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, N_OMEGA)).to(device)
    return batched, omega, 1e-4 / omega


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 1

    # 1. card
    device = torch.device('cuda', 0)
    card = _card_label()
    print(f'card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}')
    clock = [time.perf_counter()]

    def lap(phases):
        """Prints the host-clock seconds since the last lap."""
        now = time.perf_counter()
        print(f'phase time: {phases} {now - clock[0]:.2f} s')
        clock[0] = now

    # 2. build
    t0 = time.perf_counter()
    lib, report = _build.build('dword_digits')
    print(f'build: {lib.name} in {time.perf_counter() - t0:.1f} s '
          '(nvcc -Xptxas -v):')
    print(report.strip())

    # 3. kernel against plain version
    kernel_err, kernel_ms, plain_ms, bound_ms = check_kernel(device, card)
    lap('2-3')

    # 4. main path
    batched, omega, spectrum = flagship_inputs(device)
    dword.launches = 0
    infid = functional.batched_infidelity(batched, spectrum, omega,
                                          chunk_size=CHUNK)
    torch.cuda.synchronize()
    launches = dword.launches
    route = config.contraction_mode(device)
    print(f'main path: batched_infidelity batch {BATCH} chunk {CHUNK}, '
          f'route {route!r}, dword_digits launches {launches}')
    if launches <= 0:
        raise AssertionError('the main path never launched dword_digits')
    if infid.shape != (BATCH, 18) or not torch.isfinite(infid).all():
        raise AssertionError(f'bad infidelities: shape {tuple(infid.shape)}'
                             f', finite {bool(torch.isfinite(infid).all())}')
    stat, ratios = functional._batched_stat(batched, spectrum, omega, CHUNK,
                                            'stat', route)
    print(f'escalation statistic: max {ratios.max().item():.6e} over the '
          f'batch (threshold {config.ESCALATION_TOL})')
    if not ratios.max().item() < config.ESCALATION_TOL:
        raise AssertionError('the escalation statistic crossed its '
                             'threshold: the main path re-ran natively')
    if not torch.equal(stat, infid):
        raise AssertionError('batched_infidelity differs from its '
                             'unescalated fast pass')
    native = functional.batched_infidelity(batched, spectrum, omega,
                                           chunk_size=CHUNK,
                                           contract='native')
    torch.cuda.synchronize()
    diff = (infid - native).abs()
    print(f'ozaki against native on the card: row 0 max |diff| '
          f'{diff[0].max().item():.6e}, all rows {diff.max().item():.6e} '
          f'(row 0 bound {PARITY}); row 0 infidelity sum '
          f'{infid[0].sum().item():.12e}')
    if not diff[0].max().item() <= PARITY:
        raise AssertionError('row 0 of the Ozaki route is off the native '
                             'route by more than the parity contract')
    cpu_p = qft.qft_pulse_arrays(4, device='cpu')
    cpu_row0 = functional.infidelity(cpu_p, spectrum.cpu(), omega.cpu(),
                                     contract='native')
    cpu_diff = (native[0].cpu() - cpu_row0).abs().max().item()
    print(f'native on the card against native on the CPU, row 0: max '
          f'|diff| {cpu_diff:.6e} (bound {CPU_PARITY})')
    if not cpu_diff <= CPU_PARITY:
        raise AssertionError('the card and the CPU disagree on the native '
                             'route')

    # 5. timing
    for name in ('ozaki', 'native'):
        ms = _median_ms(lambda: functional.batched_infidelity(
            batched, spectrum, omega, chunk_size=CHUNK, contract=name),
            N_TIMED)
        print(f'timing: {name} route {ms / BATCH:.4f} ms/pulse (median of '
              f'{N_TIMED}, batch {BATCH}, chunk {CHUNK}) [{card}]')
    print(f'peak device memory: '
          f'{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB')
    lap('4-5')

    # 6. object path
    object_launches, object_infid = object_path(device, card, native[0],
                                                infid[0])
    lap('6')

    # 7. error transfer matrix
    etm_launches = etm_flagship(device, card, object_infid)
    lap('7a')
    etm_second_order(device, card)
    lap('7b')
    table_launches = second_order_tables(device, card)
    lap('7c')
    etm_grad_launches = etm_gradient(device, card)
    lap('7d')

    # 8. gradients
    grad_launches, grad_8a = autograd_flagship(device, card, batched, omega,
                                               spectrum)
    analytic_flagship(device, card)
    grad_config(device, card)
    lap('8')

    # 9. concatenation in time
    concat_launches = {
        **concat_flagship(device, card, object_infid),
        **concat_periodic(device, card),
        **concat_distinct(device, card, batched),
        'concatenate (d = 2 trains, dd, rb)': concat_small(device, card),
        'concatenate (second order)': concat_second_order(device, card),
        'second-order tables (7c)': table_launches}
    lap('9')

    # 10. composition in space, spectroscopy, exchange
    extended, space_launches = extend_flagship(device, card)
    space_launches.update(remap_extended(device, card, extended))
    del extended
    space_launches['spectroscopy (CPMG-8 family)'] = spectroscopy_cpmg(
        device, card)
    space_launches['models.exchange.cnot_pulse'] = exchange_cnot(device,
                                                                 card)
    concat_launches.update(space_launches)
    lap('10')

    # 11. the sharded paths
    mesh, shard_launches = sharded_flagship(device, card, batched, omega,
                                            spectrum, infid)
    concat_launches.update(shard_launches)
    concat_launches.update(two_ranks(device, card, batched, omega, infid,
                                     grad_8a))
    concat_launches.update(grape_flagship(device, card, mesh, batched, omega,
                                          spectrum, grad_8a))
    torch.distributed.destroy_process_group()
    lap('11')

    # 12. the entry points and the escalation
    entry_launches = entry_flagship(device, card, infid[0], native[0])
    lap('12a')
    concat_launches.update(cpmg_pathology(device, card))
    lap('12c')

    # 13. the examples
    concat_launches.update(examples_on_card(device, card))
    lap('13')

    print(card)
    print(json.dumps({'kernels': [{
        'name': 'dword_digits', 'route': 'cuda',
        'source': 'filter_functions_tpu_torch/csrc/dword_digits.cu',
        'replaces': 'filter_functions_tpu/ops/dword_pallas.py:198',
        'launches': launches + object_launches + etm_launches
        + grad_launches + etm_grad_launches + entry_launches
        + sum(concat_launches.values()),
        'launches_by_path': {
            **concat_launches,
            'functional.batched_infidelity': launches,
            'numeric.infidelity (PulseSequence)': object_launches,
            'numeric.error_transfer_matrix (PulseSequence)': etm_launches,
            'functional.batched_infidelity (autograd)': grad_launches,
            'functional.error_transfer_matrix (autograd, 7d)':
            etm_grad_launches,
            'entry.entry (one call)': entry_launches},
        'max_abs_err': kernel_err, 'ms': kernel_ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': 'bytes', 'bound': 'memory',
        'pct_of_bound': 100 * bound_ms / kernel_ms, 'library_ms': None,
        'library_note': 'no single PyTorch call computes the digit '
                        'slices'}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def object_path(device, card, native_row0, ozaki_row0):
    """Phase 6: the object API on the flagship; returns the kernel's
    launches in the first call and the infidelities."""
    pulse = qft.qft_pulse_sequence(4, device=device)
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, N_OMEGA)).to(device)
    spectrum = 1e-4 / omega
    torch.cuda.reset_peak_memory_stats(device)
    dword.launches = 0
    infid = fft.infidelity(pulse, spectrum, omega)
    torch.cuda.synchronize()
    launches = dword.launches
    print(f'object path: fft.infidelity(PulseSequence) on {pulse.device}, '
          f'dword_digits launches {launches}')
    if launches <= 0:
        raise AssertionError('the object path never launched dword_digits')
    if infid.shape != (18,) or not torch.isfinite(infid).all():
        raise AssertionError(f'bad infidelities: shape {tuple(infid.shape)}'
                             f', finite {bool(torch.isfinite(infid).all())}')
    to_native = (infid - native_row0).abs().max().item()
    to_ozaki = (infid - ozaki_row0).abs().max().item()
    print(f'object path against phase 4 row 0: native max |diff| '
          f'{to_native:.6e} (bound {PARITY}), Ozaki max |diff| '
          f'{to_ozaki:.6e} (bound {OBJECT_PARITY}); infidelity sum '
          f'{infid.sum().item():.12e}')
    if not to_native <= PARITY:
        raise AssertionError('the object path is off the native route by '
                             'more than the parity contract')
    if not to_ozaki <= OBJECT_PARITY:
        raise AssertionError('the object path is off the functional Ozaki '
                             'route')
    dword.launches = 0
    again = fft.infidelity(pulse, spectrum, omega)
    torch.cuda.synchronize()
    if dword.launches != 0 or not torch.equal(again, infid):
        raise AssertionError(f'the cached second call launched '
                             f'{dword.launches} kernels or changed the '
                             'result')
    filter_function = pulse.get_filter_function(omega)
    if filter_function.shape != (18, 18, N_OMEGA) or \
            filter_function.dtype != torch.complex128:
        raise AssertionError(f'bad filter function: '
                             f'{tuple(filter_function.shape)} '
                             f'{filter_function.dtype}')
    print('object path: the cached second call launched nothing; filter '
          f'function {tuple(filter_function.shape)} {filter_function.dtype}')
    peak = torch.cuda.max_memory_allocated(device)

    def cold():
        pulse.cleanup('all')
        fft.infidelity(pulse, spectrum, omega)
    print(f'timing: object path {_median_ms(cold, N_TIMED):.4f} ms per '
          f'cold call (median of {N_TIMED}, caches cleared before each); '
          f'peak device memory {peak / 2**30:.2f} GiB [{card}]')
    return launches, infid


def etm_flagship(device, card, infid) -> int:
    """Phase 7a: the first-order ETM of the flagship through the object
    API; returns the kernel's launches in the first call."""
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, N_OMEGA)).to(device)
    spectrum = 1e-4 / omega
    pulse = qft.qft_pulse_sequence(4, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    dword.launches = 0
    etm = fft.error_transfer_matrix(pulse, spectrum, omega)
    torch.cuda.synchronize()
    launches = dword.launches
    peak = torch.cuda.max_memory_allocated(device)
    print(f'etm flagship: fft.error_transfer_matrix(PulseSequence) on '
          f'{pulse.device}, basis of {len(pulse.basis)}, dword_digits '
          f'launches {launches}')
    if launches <= 0:
        raise AssertionError('the ETM path never launched dword_digits')
    if etm.shape != (256, 256) or etm.dtype != torch.float64 or \
            not torch.isfinite(etm).all():
        raise AssertionError(f'bad ETM: {tuple(etm.shape)} {etm.dtype}, '
                             f'finite {bool(torch.isfinite(etm).all())}')

    cumulant = numeric.calculate_cumulant_function(pulse, spectrum, omega)
    from_trace = (-torch.einsum('aii->', cumulant) / pulse.d**2).item()
    infid_sum = infid.sum().item()
    identity = abs(from_trace - infid_sum) / infid_sum
    print(f'etm flagship: -tr K / d^2 {from_trace:.12e} against the '
          f'infidelity sum {infid_sum:.12e}: relative {identity:.3e} '
          f'(bound {TRACE_IDENTITY})')
    if not identity <= TRACE_IDENTITY:
        raise AssertionError('-tr K / d^2 is off the infidelity')

    native = qft.qft_pulse_sequence(4, device=device)
    native.cache_control_matrix(
        omega, numeric.calculate_control_matrix_from_scratch(
            native.eigvals, native.eigvecs, native.propagators, omega,
            native.basis, native.n_opers_dev, native.n_coeffs, native.dt,
            t=native.t, contract='native'))
    etm_native = fft.error_transfer_matrix(native, spectrum, omega)
    to_native = (etm - etm_native).abs().max().item()
    cpu = fft.error_transfer_matrix(qft.qft_pulse_sequence(4, device='cpu'),
                                    spectrum.cpu(), omega.cpu())
    to_cpu = (etm_native.cpu() - cpu).abs().max().item()
    is_cp = superoperator.liouville_is_CP(etm, pulse.basis)
    print(f'etm flagship: Ozaki against native max |diff| {to_native:.6e} '
          f'(bound {ETM_PARITY}); card native against CPU {to_cpu:.6e} '
          f'(bound {CPU_PARITY}); completely positive {is_cp}')
    if not to_native <= ETM_PARITY:
        raise AssertionError('the Ozaki ETM is off the native one')
    if not to_cpu <= CPU_PARITY:
        raise AssertionError('the card and the CPU disagree on the ETM')
    if not is_cp:
        raise AssertionError('the ETM is not completely positive')

    def cold():
        pulse.cleanup('all')
        dword.launches = 0
        fft.error_transfer_matrix(pulse, spectrum, omega)
        if dword.launches <= 0:
            raise AssertionError('a cold ETM call launched no kernel')
    print(f'timing: etm flagship {_median_ms(cold, N_TIMED):.4f} ms '
          f'per cold call (median of {N_TIMED}, caches cleared before '
          f'each); peak device memory {peak / 2**30:.2f} GiB [{card}]')
    return launches


def second_order_inputs(device):
    """bench.py's config_second_order inputs: (PulseArrays on *device*,
    host arrays, omega, spectrum)."""
    d, n_dt, n_omega, batch = SO_SHAPE
    rng = np.random.default_rng(7)

    def herm_traceless(k):
        a = rng.standard_normal((k, d, d)) + 1j * rng.standard_normal(
            (k, d, d))
        a = (a + a.conj().swapaxes(-1, -2)) / 2
        return a - (np.trace(a, axis1=-2, axis2=-1)[:, None, None]
                    * np.eye(d) / d)

    c_opers, n_opers = herm_traceless(2), herm_traceless(2)
    c_coeffs = rng.standard_normal((batch, 2, n_dt))
    n_coeffs = np.ones((batch, 2, n_dt))
    dt = np.broadcast_to(1 - rng.random(n_dt), (batch, n_dt)).copy()
    host = dict(c_opers=c_opers, c_coeffs=c_coeffs, n_opers=n_opers,
                n_coeffs=n_coeffs, dt=dt)
    basis = fft.Basis.ggm(d)
    p = functional.PulseArrays(
        *(torch.from_numpy(host[f]).to(device)
          for f in ('c_opers', 'c_coeffs', 'n_opers', 'n_coeffs', 'dt')),
        basis.tensor(device))
    omega = torch.from_numpy(np.geomspace(1e-1, 1e1, n_omega)).to(device)
    return p, host, basis, omega, 1e-4 / omega


def etm_second_order(device, card) -> None:
    """Phase 7b: the batched second-order ETM at config_second_order's
    shapes."""
    d, _, _, batch = SO_SHAPE
    p, host, basis, omega, spectrum = second_order_inputs(device)
    etm = functional.batched_error_transfer_matrix(p, spectrum, omega, basis,
                                                   second_order=True)
    torch.cuda.synchronize()
    if etm.shape != (batch, d * d, d * d) or not torch.isfinite(etm).all():
        raise AssertionError(f'bad batched ETM: {tuple(etm.shape)}, finite '
                             f'{bool(torch.isfinite(etm).all())}')

    def pulse(b, dev):
        return fft.PulseSequence.from_arrays(
            host['c_opers'], ['A', 'B'], host['c_coeffs'][b],
            host['n_opers'], ['a', 'b'], host['n_coeffs'][b], host['dt'][b],
            basis=basis, device=dev)

    for b in (0, batch - 1):
        single = fft.error_transfer_matrix(pulse(b, device), spectrum, omega,
                                           second_order=True)
        to_object = (etm[b] - single).abs().max().item()
        row = p._replace(c_coeffs=p.c_coeffs[b].cpu(),
                         n_coeffs=p.n_coeffs[b].cpu(), dt=p.dt[b].cpu(),
                         c_opers=p.c_opers.cpu(), n_opers=p.n_opers.cpu(),
                         basis=p.basis.cpu())
        cpu = functional.error_transfer_matrix(row, spectrum.cpu(),
                                               omega.cpu(), basis,
                                               second_order=True)
        to_cpu = (etm[b].cpu() - cpu).abs().max().item()
        print(f'etm second order: row {b} against the object path max '
              f'|diff| {to_object:.6e} (bound {ETM_BATCH_PARITY}), against '
              f'the CPU {to_cpu:.6e} (bound {CPU_PARITY})')
        if not to_object <= ETM_BATCH_PARITY:
            raise AssertionError(f'row {b} is off the object path')
        if not to_cpu <= CPU_PARITY:
            raise AssertionError(f'row {b}: the card and the CPU disagree')

    pulse_0 = pulse(0, device)
    second = numeric.calculate_cumulant_function(
        pulse_0, spectrum, omega, second_order=True) \
        - numeric.calculate_cumulant_function(pulse_0, spectrum, omega)
    asym = (second + second.mT).abs().max().item()
    print(f'etm second order: K2 - K1 of row 0 antisymmetric to '
          f'{asym:.3e} (bound {ANTISYMMETRY}), max |K2 - K1| '
          f'{second.abs().max().item():.3e}')
    if not asym <= ANTISYMMETRY:
        raise AssertionError('the second-order cumulant is not '
                             'antisymmetric')

    ms = _median_ms(lambda: functional.batched_error_transfer_matrix(
        p, spectrum, omega, basis, second_order=True), N_TIMED)
    print(f'timing: etm second order {ms / batch:.4f} ms per evaluation '
          f'(median of {N_TIMED} calls of batch {batch}) [{card}]')


def _timed(fn, device, card, label, per, unit):
    """fn(): a first call whose result is returned, then the median of
    N_TIMED calls in ms per *unit* (the call over *per*) and the peak
    device memory of those calls, printed with the memory held before
    them."""
    out = fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    ms = _median_ms(fn, N_TIMED)
    peak = torch.cuda.max_memory_allocated(device)
    print(f'timing: {label} {ms / per:.4f} ms per {unit} (median of '
          f'{N_TIMED}); peak device memory {peak / 2**30:.3f} GiB, '
          f'{held / 2**30:.3f} GiB held before [{card}]')
    return out


def reduced_term(omega, eigvals, dt, weights, lattice=False):
    """The frequency-reduced incomplete-step term ell[..., g, a, ij, mn]
    = sum_w weights[a, w] I[..., g, w, ij, mn] of the frequency shifts,
    over chunks of segments: from the separable tables
    (``numeric._factored_weighted_lattice``, in the chunks of
    ``numeric._second_order_diag_shifts``) or, as its plain version,
    weights @ each chunk's K2 lattice I
    (``numeric._second_order_integral_single``, LATTICE_TEMPS lattices
    per segment against ``config.memory_budget``)."""
    G, d = eigvals.shape[-2:]
    lead = eigvals.shape[:-2]
    n_nops, n_w = weights.shape
    d2 = d * d
    if lattice:
        chunk = numeric._pick_chunk(
            G, eigvals[..., 0, 0].numel() * n_w * d2 * d2 * LATTICE_TEMPS
            * 16, config.memory_budget(eigvals.device))
    else:
        chunk = numeric._factored_chunk(eigvals, n_w, 8 * n_nops * d2)
    parts = []
    for start in range(0, G, chunk):
        ev, seg_dt = eigvals[..., start:start + chunk, :], \
            dt[..., start:start + chunk]
        if not lattice:
            parts.append(numeric._factored_weighted_lattice(
                omega, ev, seg_dt, weights))
            continue
        int2 = numeric._second_order_integral_single(omega, ev, seg_dt)
        g = int2.shape[-6]
        ell = weights.to(int2.dtype) @ int2.reshape(*lead, g, n_w, d2 * d2)
        parts.append(ell.reshape(*lead, g, n_nops, d2, d2))
    return torch.cat(parts, -4)


def _reduced_terms_agree(name, omega, eigvals, dt, weights, device, card,
                         per, bound):
    """Times the frequency-reduced term from the tables and from the K2
    lattice (:func:`reduced_term`) and checks them within *bound* of
    the largest entry."""
    got = {kind: _timed(lambda: reduced_term(omega, eigvals, dt, weights,
                                             kind == 'K2 lattice'),
                        device, card, f'{name}, frequency-reduced term from '
                        f'the {kind}', per, 'evaluation')
           for kind in ('separable tables', 'K2 lattice')}
    want = got['K2 lattice']
    scale = want.abs().max().item()
    rel = (got['separable tables'] - want).abs().max().item() / scale
    print(f'{name}: frequency-reduced term {tuple(want.shape)}, tables '
          f'against lattice max |diff| {rel:.6e} of the largest entry '
          f'{scale:.6e} (bound {bound})')
    _check(f'{name} tables against lattice', rel, bound)


def qft3_inputs(device):
    """7c(ii)'s inputs: (the 3-qubit QFT pulse's PulseArrays jittered to
    a batch (:func:`_jittered`), its Basis, omega, 1e-4/omega)."""
    n_qubits, n_w, batch = QFT3_SHAPE
    p = _jittered(qft.qft_pulse_arrays(n_qubits, device=device), batch)
    basis = qft.qft_pulse_sequence(n_qubits, device=device).basis
    if not torch.equal(basis.tensor(device), p.basis):
        raise AssertionError("7c(ii): the basis differs from the arrays'")
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, n_w)).to(device)
    return p, basis, omega, 1e-4 / omega


def flagship_shift_inputs(device):
    """7c(iii)'s inputs: the arguments of ``numeric.
    _second_order_diag_shifts`` that ``functional._etm_core`` builds for
    row 0 of the flagship batch (eigenvalues, transformed noise operators
    and basis, per-step and padded cumulative control matrices, omega,
    dt, the weights of S = 1e-4/omega)."""
    batched, omega, spectrum = flagship_inputs(device)
    p = batched._replace(c_coeffs=batched.c_coeffs[0],
                         n_coeffs=batched.n_coeffs[0], dt=batched.dt[0])
    eigvals, (_, n_t, b_t, ph, integral), _ = functional._prep(
        p, p.c_coeffs, p.n_coeffs, p.dt, omega)
    step = numeric._ctrlmat_step_contract(n_t, integral, b_t, ph)
    cumul_padded = numeric._pad_cumulative(
        step, step.cumsum(-4)[..., :-1, :, :, :])
    weights = numeric._spectral_weights(spectrum, omega, p.n_opers.shape[0])
    return eigvals, n_t, b_t, step, cumul_padded, omega, p.dt, weights


def second_order_tables(device, card) -> int:
    """Phase 7c: the second-order term from the separable tables of the
    K2 lattice, against the lattice, at 7b's inputs, at the 3-qubit QFT
    pulse and on the flagship's frequency shifts; returns the kernel's
    launches (none)."""
    launches = dword.launches

    # (i) 7b's inputs, a diagonal and a cross-spectrum
    d, _, _, batch = SO_SHAPE
    p, host, basis, omega, spectrum = second_order_inputs(device)
    cross = torch.stack([torch.stack([spectrum, spectrum / 2]),
                         torch.stack([spectrum / 2, spectrum])])
    for kind, s in (('diagonal', spectrum), ('cross', cross)):
        etm = _timed(lambda: functional.batched_error_transfer_matrix(
            p, s, omega, basis, second_order=True), device, card,
            f'7c(i) second-order ETM at 7b, {kind} spectrum', batch,
            'evaluation')
        if etm.shape != (batch, d * d, d * d) or \
                not torch.isfinite(etm).all():
            raise AssertionError(f'7c(i): bad ETM, {kind} spectrum')
        for b in (0, batch - 1):
            pulse = fft.PulseSequence.from_arrays(
                host['c_opers'], ['A', 'B'], host['c_coeffs'][b],
                host['n_opers'], ['a', 'b'], host['n_coeffs'][b],
                host['dt'][b], basis=basis, device=device)
            pulse.cache_filter_function(omega, order=2,
                                        cache_intermediates=True)
            lattice = fft.error_transfer_matrix(pulse, s, omega,
                                                second_order=True)
            diff = (etm[b] - lattice).abs().max().item()
            print(f'7c(i): {kind} spectrum, row {b} against the object '
                  f'path on the cached K2 lattice max |diff| {diff:.6e} '
                  f'(bound {LATTICE_PARITY})')
            _check(f'7c(i) {kind} row {b} against the lattice', diff,
                   LATTICE_PARITY)
    eigvals = functional._prep(p, p.c_coeffs, p.n_coeffs, p.dt, omega)[0]
    _reduced_terms_agree('7c(i)', omega, eigvals, p.dt,
                         numeric._spectral_weights(spectrum, omega, 2),
                         device, card, batch, LATTICE_PARITY)
    del p, eigvals, etm

    # (ii) the 3-qubit QFT pulse at full width
    p, basis, omega, spectrum = qft3_inputs(device)
    n_qubits, n_w, batch = QFT3_SHAPE
    n_b = len(basis)
    etm = _timed(lambda: functional.batched_error_transfer_matrix(
        p, spectrum, omega, basis, second_order=True), device, card,
        f'7c(ii) second-order ETM of the {n_qubits}-qubit QFT pulse (d = '
        f'{p.c_opers.shape[-1]}, {n_b} basis elements, {n_w} frequencies, '
        f'batch {batch})', batch, 'evaluation')
    if etm.shape != (batch, n_b, n_b) or not torch.isfinite(etm).all():
        raise AssertionError('7c(ii): bad ETM')
    eigvals = functional._prep(p, p.c_coeffs, p.n_coeffs, p.dt, omega)[0]
    weights = numeric._spectral_weights(spectrum, omega, p.n_opers.shape[0])
    _reduced_terms_agree('7c(ii)', omega, eigvals, p.dt, weights, device,
                         card, batch, WIDE_LATTICE_PARITY)
    del p, basis, eigvals, etm

    # (iii) the flagship's frequency shifts
    args = flagship_shift_inputs(device)
    shifts = _timed(lambda: numeric._second_order_diag_shifts(*args),
                    device, card, f'7c(iii) flagship frequency shifts '
                    f'({N_OMEGA} frequencies)', 1, 'call')
    print(f'7c(iii): shifts {tuple(shifts.shape)}, largest entry '
          f'{shifts.abs().max().item():.6e}')
    if not torch.isfinite(shifts).all():
        raise AssertionError('7c(iii): the shifts are not finite')
    eigvals, _, _, _, _, omega, dt, weights = args
    _reduced_terms_agree('7c(iii)', omega, eigvals, dt, weights, device,
                         card, 1, WIDE_LATTICE_PARITY)

    launches = dword.launches - launches
    print(f'7c: dword_digits launches {launches}')
    if launches:
        raise AssertionError('7c launched the kernel')
    return launches


def etm_gradient(device, card) -> int:
    """Phase 7d: autograd through a weighted sum of the flagship's
    functional ETM (row 0, 1000 frequencies), first and second order,
    against central differences (the flagship is degenerate on segments
    0-2), each beside the derivative without its degenerate-eigenspace
    terms; returns the kernel's launches in the autograd calls."""
    p = qft.qft_pulse_arrays(4, device=device)
    basis = qft.qft_pulse_sequence(4, device=device).basis
    omega, spectrum = _omega_spectrum(device)
    rng = np.random.default_rng(14)
    weights = torch.from_numpy(rng.standard_normal((256, 256))).to(device)
    direction = torch.from_numpy(rng.standard_normal(
        tuple(p.c_coeffs.shape))).to(device)
    terms = {'_degenerate_control_matrix': numeric._degenerate_control_matrix,
             '_degenerate_incomplete_steps':
             numeric._degenerate_incomplete_steps}
    launches = 0
    for second_order in (False, True):
        order = 'second' if second_order else 'first'

        def loss(c):
            return (functional.error_transfer_matrix(
                p._replace(c_coeffs=c), spectrum, omega, basis,
                second_order) * weights).sum()

        def derivative():
            c = p.c_coeffs.clone().requires_grad_(True)
            grad, = torch.autograd.grad(loss(c), c)
            return (grad * direction).sum().item()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        dword.launches = 0
        got = derivative()
        launches += dword.launches
        peak = torch.cuda.max_memory_allocated(device)
        h = ETM_GRAD_STEP
        with torch.no_grad():
            central = ((loss(p.c_coeffs + h * direction)
                        - loss(p.c_coeffs - h * direction)) / (2 * h)).item()
        err = abs(got - central) / abs(central)
        # without the zero-valued terms of the derivative inside degenerate
        # eigenspaces: the parent's first order, and the second order that
        # the parent refused
        for name in terms:
            setattr(numeric, name, lambda *args, **kwargs: None)
        try:
            without = abs(derivative() - central) / abs(central)
        finally:
            for name, fn in terms.items():
                setattr(numeric, name, fn)
        print(f'etm gradient: functional.error_transfer_matrix of the '
              f'flagship, {order} order, {N_OMEGA} frequencies: autograd '
              f'directional derivative {got:.12e}, central differences '
              f'(h = {h}) {central:.12e}: relative {err:.3e} (bound '
              f'{ETM_GRAD_PARITY}); without the degenerate-eigenspace terms '
              f'{without:.3e}; dword_digits launches {dword.launches}')
        _check(f'7d: the {order}-order ETM gradient against central '
               'differences', err, ETM_GRAD_PARITY)
        ms = _median_ms(derivative, N_TIMED)
        print(f'timing: etm gradient, {order} order, {ms:.4f} ms per forward '
              f'plus backward (median of {N_TIMED}); peak device memory '
              f'{peak / 2**30:.2f} GiB [{card}]')
    return launches


def _infidelity_grad(p, spectrum, omega, chunk_size=None, contract=None):
    """(infidelities, gradient of their sum w.r.t. the control
    coefficients, kernel launches of the forward pass, of the backward
    pass) of the pulses *p*."""
    c_coeffs = p.c_coeffs.detach().clone().requires_grad_(True)
    dword.launches = 0
    infid = functional.batched_infidelity(p._replace(c_coeffs=c_coeffs),
                                          spectrum, omega, chunk_size,
                                          contract)
    forward = dword.launches
    grad, = torch.autograd.grad(infid.sum(), c_coeffs)
    if grad.is_cuda:
        torch.cuda.synchronize()
    return infid.detach(), grad, forward, dword.launches - forward


def _rel(a, b) -> float:
    """max |a - b| relative to max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def autograd_flagship(device, card, batched, omega, spectrum) -> int:
    """Phase 8a: autograd of the flagship's batched infidelity on both
    routes; returns the kernel's launches in the forward pass and the
    default route's gradient."""
    p = batched._replace(c_coeffs=batched.c_coeffs[:GRAD_BATCH],
                         n_coeffs=batched.n_coeffs[:GRAD_BATCH],
                         dt=batched.dt[:GRAD_BATCH])
    route = config.contraction_mode(device)
    torch.cuda.reset_peak_memory_stats(device)
    _, grad, forward, backward = _infidelity_grad(p, spectrum, omega, CHUNK)
    peak = torch.cuda.max_memory_allocated(device)
    print(f'autograd flagship: batch {GRAD_BATCH} chunk {CHUNK}, route '
          f'{route!r}, dword_digits launches {forward} forward, {backward} '
          f'backward')
    if forward != GRAD_BATCH // CHUNK or backward != 0:
        raise AssertionError('the autograd path launched dword_digits '
                             f'{forward} times forward and {backward} '
                             f'backward, not {GRAD_BATCH // CHUNK} and 0')
    if grad.shape != p.c_coeffs.shape or not torch.isfinite(grad).all():
        raise AssertionError(f'bad gradient: {tuple(grad.shape)}, finite '
                             f'{bool(torch.isfinite(grad).all())}')
    _, native, _, _ = _infidelity_grad(p, spectrum, omega, CHUNK, 'native')
    to_native = _rel(grad, native)
    cpu_p = qft.qft_pulse_arrays(4, device='cpu')
    _, cpu, _, _ = _infidelity_grad(
        cpu_p._replace(c_coeffs=cpu_p.c_coeffs[None],
                       n_coeffs=cpu_p.n_coeffs[None], dt=cpu_p.dt[None]),
        spectrum.cpu(), omega.cpu(), contract='native')
    to_cpu = _rel(native[0].cpu(), cpu[0])
    print(f'autograd flagship: Ozaki against native gradient {to_native:.3e} '
          f'relative (bound {GRAD_PARITY}); card native row 0 against the '
          f'CPU {to_cpu:.3e} (bound {GRAD_CPU_PARITY}); max |grad| '
          f'{native.abs().max().item():.6e}')
    if not to_native <= GRAD_PARITY:
        raise AssertionError('the Ozaki gradient is off the native one')
    if not to_cpu <= GRAD_CPU_PARITY:
        raise AssertionError('the card and the CPU disagree on the gradient')
    for name in ('ozaki', 'native'):
        ms = _median_ms(lambda: _infidelity_grad(p, spectrum, omega, CHUNK,
                                                 name), N_TIMED)
        print(f'timing: autograd {name} route {ms / GRAD_BATCH:.4f} ms/pulse '
              f'forward plus backward (median of {N_TIMED}, batch '
              f'{GRAD_BATCH}, chunk {CHUNK}) [{card}]')
    print(f'autograd flagship: peak device memory {peak / 2**30:.2f} GiB '
          f'(Ozaki route) [{card}]')
    return forward, grad


def analytic_flagship(device, card) -> None:
    """Phase 8b: the analytic infidelity derivative of the flagship
    against autograd."""
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, N_OMEGA_ANALYTIC)).to(
        device)
    spectrum = 1e-4 / omega
    pulse = qft.qft_pulse_sequence(4, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    analytic = fft.infidelity_derivative(pulse, spectrum, omega)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    if analytic.shape != (18, 13, 18) or not torch.isfinite(analytic).all():
        raise AssertionError(f'bad analytic derivative: '
                             f'{tuple(analytic.shape)}')
    p = qft.qft_pulse_arrays(4, device=device)
    _, grad, _, _ = _infidelity_grad(
        p._replace(c_coeffs=p.c_coeffs[None], n_coeffs=p.n_coeffs[None],
                   dt=p.dt[None]), spectrum, omega, contract='native')
    to_autograd = _rel(analytic.sum(0).T, grad[0])
    w = pulse.eigvals
    gaps = (w[..., :, None] - w[..., None, :]).abs()
    near = ((gaps > 0)
            & (gaps <= numeric._DEGENERATE_GAP * (1 + w[..., None, :].abs())))
    exact = (gaps == 0).sum().item() - w.numel()
    print(f'analytic flagship: {N_OMEGA_ANALYTIC} frequencies, summed over '
          f'noise operators against native autograd {to_autograd:.3e} '
          f'relative (bound {ANALYTIC_PARITY}); eigenvalue pairs exactly '
          f'degenerate {exact}, nearly degenerate (0 < gap <= '
          f'{numeric._DEGENERATE_GAP} (1 + |w|)) {near.sum().item()}')
    if not to_autograd <= ANALYTIC_PARITY:
        raise AssertionError('the analytic derivative is off autograd')

    def cold():
        pulse.cleanup('all')
        fft.infidelity_derivative(pulse, spectrum, omega)
    ms = _median_ms(cold, 3)
    print(f'timing: analytic flagship {ms:.4f} ms per cold call (median of '
          f'3, caches cleared before each); peak device memory '
          f'{peak / 2**30:.2f} GiB [{card}]')


def grad_config(device, card) -> None:
    """Phase 8c: bench.py's config_grad batch through autograd, row 0
    against the analytic derivative."""
    n_dt, n_omega, batch = GRAD_SHAPE
    X, Y, Z = (torch.from_numpy(m) for m in fft.util.paulis[1:])
    rng = np.random.default_rng(3)
    c_coeffs = rng.standard_normal((batch, 2, n_dt))
    dt = np.broadcast_to(1 - rng.random(n_dt), (batch, n_dt)).copy()
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, n_omega)).to(device)
    spectrum = 1e-3 / omega
    p = functional.PulseArrays(
        torch.stack([X / 2, Y / 2]).to(device),
        torch.from_numpy(c_coeffs).to(device), (Z / 2)[None].to(device),
        torch.ones(batch, 1, n_dt, dtype=torch.float64, device=device),
        torch.from_numpy(dt).to(device), fft.Basis.ggm(2).tensor(device))
    _, grad, _, _ = _infidelity_grad(p, spectrum, omega)
    pulse = fft.PulseSequence(
        [[X.numpy() / 2, c_coeffs[0, 0], 'X'],
         [Y.numpy() / 2, c_coeffs[0, 1], 'Y']],
        [[Z.numpy() / 2, np.ones(n_dt), 'Z']], dt[0], device=device)
    analytic = fft.infidelity_derivative(pulse, spectrum, omega)
    err = (grad[0] - analytic.sum(0).T).abs().max().item()
    print(f'grad config: batch {batch}, {n_dt} segments, {n_omega} '
          f'frequencies; row 0 autograd against the analytic derivative max '
          f'|diff| {err:.3e} (bound {GRAD_CONFIG_PARITY})')
    if not (torch.isfinite(grad).all() and err <= GRAD_CONFIG_PARITY):
        raise AssertionError('config_grad: autograd is off the analytic '
                             'derivative')
    ms = _median_ms(lambda: _infidelity_grad(p, spectrum, omega), N_TIMED)
    print(f'timing: grad config autograd {ms / batch:.4f} ms/pulse (median '
          f'of {N_TIMED}, batch {batch}) [{card}]')


def _omega_spectrum(device):
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, N_OMEGA)).to(device)
    return omega, 1e-4 / omega


def _native_control_matrix(pulse, omega, **kw):
    """The from-scratch control matrix of *pulse* on the native route."""
    return numeric.calculate_control_matrix_from_scratch(
        pulse.eigvals, pulse.eigvecs, pulse.propagators, omega, pulse.basis,
        pulse.n_opers_dev, pulse.n_coeffs, pulse.dt, t=pulse.t,
        contract='native', **kw)


def _check(name, value, bound):
    if not value <= bound:
        raise AssertionError(f'{name}: {value:.3e} exceeds {bound}')


def concat_flagship(device, card, object_infid) -> dict:
    """Phase 9a: the flagship built live and composed from its gates;
    returns the kernel's launches by what made them."""
    omega, spectrum = _omega_spectrum(device)
    live = qft.qft_pulse(4, device=device)
    named = qft.qft_pulse_sequence(4, device=device)
    diff = max(np.abs(getattr(live, f) - getattr(named, f)).max()
               for f in ('c_opers', 'c_coeffs', 'n_opers', 'n_coeffs', 'dt'))
    print(f'concat flagship: live qft_pulse(4) on {live.device} against '
          f'qft_pulse_sequence(4), five arrays: max |diff| {diff} '
          f'(tolerance 0); {len(live)} segments, identifiers '
          f'{live.c_oper_identifiers[0]} ... {live.c_oper_identifiers[-1]}')
    if diff != 0:
        raise AssertionError('the live flagship is not the flagship')

    def compose():
        gates = qft._qft_atomic_pulses(4, device=device)
        for gate in gates:
            gate.cache_filter_function(omega)
        return fft.concatenate(gates)

    torch.cuda.reset_peak_memory_stats(device)
    dword.launches = 0
    composed = compose()
    torch.cuda.synchronize()
    compose_launches = dword.launches
    peak = torch.cuda.max_memory_allocated(device)
    if not (composed.is_cached('control_matrix') and composed == live):
        raise AssertionError('the composed flagship has no control matrix '
                             'or is another pulse')
    got = composed.get_control_matrix(omega)
    to_native = _rel(got, _native_control_matrix(live, omega))
    infid = fft.infidelity(composed, spectrum, omega)
    to_object = (infid - object_infid).abs().max().item()
    dword.launches = 0
    scratch = live.get_control_matrix(omega)
    torch.cuda.synchronize()
    launches = dword.launches
    print(f'concat flagship: 9 gates cached and concatenated with '
          f'{compose_launches} dword_digits launches; composed control '
          f'matrix against native from scratch {to_native:.3e} of the '
          f'largest entry (bound {CONCAT_PARITY}), against the default '
          f'route from scratch ({launches} launch) '
          f'{_rel(got, scratch):.3e} (bound {OZAKI_CTRL_PARITY}); '
          f'infidelity against phase 6 max |diff| {to_object:.6e} (bound '
          f'{PARITY}), sum {infid.sum().item():.12e}')
    if compose_launches != 0 or launches != 1:
        raise AssertionError(f'launches: composition {compose_launches} '
                             f'(expected 0), from scratch {launches} '
                             '(expected 1)')
    _check('composed against native', to_native, CONCAT_PARITY)
    _check('composed against the default route', _rel(got, scratch),
           OZAKI_CTRL_PARITY)
    _check('composed infidelity against phase 6', to_object, PARITY)
    print(f'timing: concat flagship {_median_ms(compose, N_TIMED):.4f} ms '
          f'per cold composition (build 9 gates, cache, concatenate; '
          f'median of {N_TIMED}); peak device memory of one composition '
          f'{peak / 2**30:.2f} GiB [{card}]')
    return {'concatenate (live flagship, 9 gates)': compose_launches,
            'from scratch, default route (live flagship)': launches}


def concat_periodic(device, card) -> dict:
    """Phase 9b: periodic trains of the flagship; returns the kernel's
    launches by what made them."""
    omega, _ = _omega_spectrum(device)
    pulse = qft.qft_pulse_sequence(4, device=device)
    dword.launches = 0
    pulse.cache_filter_function(omega)
    torch.cuda.synchronize()
    launches = dword.launches
    if launches != 1:
        raise AssertionError(f'caching the flagship launched {launches} '
                             'kernels, not 1')
    short, long = TRAIN_REPEATS
    dword.launches = 0
    periodic = fft.concatenate_periodic(pulse, short)
    uniform = fft.concatenate([pulse] * short)
    copies = fft.concatenate([copy.copy(pulse) for _ in range(short)])
    got = periodic.get_control_matrix(omega)
    if not torch.equal(got, uniform.get_control_matrix(omega)):
        raise AssertionError('concatenate([p] * R) is not the closed form')
    to_copies = _rel(got, copies.get_control_matrix(omega))
    torch.cuda.synchronize()
    train_launches = dword.launches
    if train_launches != 0:
        raise AssertionError(f'composing the trains launched '
                             f'{train_launches} kernels, not 0')
    dword.launches = 0
    scratch = fft.concatenate_without_filter_function([pulse] * short)
    to_scratch = _rel(got, scratch.get_control_matrix(omega))
    torch.cuda.synchronize()
    scratch_launches = dword.launches
    print(f'concat periodic: flagship cached with {launches} launch; '
          f'{short} repeats ({len(periodic)} segments) composed with '
          f'{train_launches} launches: equal to '
          f'concatenate([qft] * {short}); against K5 on {short} copies '
          f'{to_copies:.3e} (bound {PERIODIC_PARITY}); against the pulse '
          f'from scratch (K = {len(periodic) * 256}, {scratch_launches} '
          f'launches) {to_scratch:.3e} of the largest entry (bound '
          f'{OZAKI_CTRL_PARITY})')
    _check('periodic against K5 on copies', to_copies, PERIODIC_PARITY)
    _check('periodic against from scratch', to_scratch, OZAKI_CTRL_PARITY)
    del uniform, copies, scratch, got

    torch.cuda.reset_peak_memory_stats(device)
    dword.launches = 0
    train = fft.concatenate_periodic(pulse, long)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    train_launches += dword.launches
    filter_function = train.get_filter_function(omega)
    prop = train.total_propagator
    unitarity = (prop @ prop.mH - torch.eye(16, device=device)).abs().max() \
        .item()
    print(f'concat periodic: {long} repeats ({len(train)} segments): filter '
          f'function {tuple(filter_function.shape)} finite '
          f'{bool(torch.isfinite(filter_function).all())}, max '
          f'{filter_function.abs().max().item():.6e}; total propagator '
          f'unitary to {unitarity:.3e} (bound {UNITARITY})')
    if not torch.isfinite(filter_function).all():
        raise AssertionError('the long train is not finite')
    _check('unitarity of the long train', unitarity, UNITARITY)
    ms = _median_ms(lambda: fft.concatenate_periodic(pulse, long), N_TIMED)
    print(f'timing: concat periodic {ms:.4f} ms per train of {long} '
          f'flagship pulses (closed form, median of {N_TIMED}); peak device '
          f'memory {peak / 2**30:.2f} GiB [{card}]')
    if train_launches != 0:
        raise AssertionError(f'the closed form launched {train_launches} '
                             'kernels, not 0')
    return {'cache_filter_function (flagship, the train\'s part)': launches,
            'concatenate_periodic / concatenate (flagship trains)':
                train_launches,
            'from scratch (208-segment train, native above the deep regime)':
                scratch_launches}


def concat_distinct(device, card, batched) -> dict:
    """Phase 9c: four distinct flagship-sized gates concatenated with
    their pulse correlations; returns the kernel's launches by what made
    them."""
    omega, _ = _omega_spectrum(device)
    base = qft.qft_pulse_sequence(4, device=device)

    def parts(dev, scales=batched.c_coeffs[:4].cpu().numpy()):
        return [fft.PulseSequence.from_arrays(
            base.c_opers, base.c_oper_identifiers, c_coeffs, base.n_opers,
            base.n_oper_identifiers, base.n_coeffs, base.dt, device=dev)
            for c_coeffs in scales]

    gates = parts(device)
    dword.launches = 0
    for gate in gates:
        gate.cache_control_matrix(omega)
    torch.cuda.synchronize()
    part_launches = dword.launches
    dword.launches = 0
    train = fft.concatenate(gates, calc_pulse_correlation_FF=True)
    f_pc = train.get_pulse_correlation_filter_function()
    total = train.get_filter_function(omega)
    sums = _rel(f_pc.sum((0, 1)), total)
    torch.cuda.synchronize()
    compose_launches = dword.launches
    dword.launches = 0
    scratch = fft.concatenate_without_filter_function(gates)
    to_scratch = _rel(train.get_control_matrix(omega),
                      scratch.get_control_matrix(omega))
    torch.cuda.synchronize()
    scratch_launches = dword.launches

    def native(dev):
        pulses = parts(dev)
        for p in pulses:
            p.cache_control_matrix(omega.to(dev),
                                   _native_control_matrix(p, omega.to(dev)))
        return fft.concatenate(pulses).get_control_matrix(omega.to(dev))
    dword.launches = 0
    to_cpu = _rel(native(device).cpu(), native('cpu'))
    native_launches = dword.launches
    print(f'concat distinct: 4 flagship-sized gates cached with '
          f'{part_launches} dword_digits launches and concatenated with '
          f'{compose_launches}; pulse-correlation filter '
          f'function {tuple(f_pc.shape)} sums to the total within '
          f'{sums:.3e} (bound {CONCAT_PARITY}); total control matrix '
          f'against the {len(train)}-segment pulse from scratch '
          f'({scratch_launches} launches) {to_scratch:.3e} of the largest '
          f'entry (bound {OZAKI_CTRL_PARITY}); from natively cached parts '
          f'against the CPU {to_cpu:.3e} (bound {CONCAT_PARITY})')
    if (part_launches != 4 or compose_launches != 0 or native_launches != 0
            or scratch_launches < 1):
        raise AssertionError(f'launches: parts {part_launches} (expected 4)'
                             f', composition {compose_launches} and '
                             f'natively cached parts {native_launches} '
                             f'(expected 0), from scratch {scratch_launches} '
                             '(expected one per segment chunk)')
    _check('pulse correlations sum to the total', sums, CONCAT_PARITY)
    _check('K5 against from scratch', to_scratch, OZAKI_CTRL_PARITY)
    _check('K5 on the card against the CPU', to_cpu, CONCAT_PARITY)
    dword.launches = 0
    ms = _median_ms(lambda: fft.concatenate(
        gates, calc_pulse_correlation_FF=True), N_TIMED)
    compose_launches += dword.launches
    print(f'timing: concat distinct {ms:.4f} ms per concatenation of 4 '
          f'cached gates with pulse correlations (median of {N_TIMED}, '
          f'{dword.launches} launches) [{card}]')
    if compose_launches != 0:
        raise AssertionError('the timed concatenations launched the kernel')
    return {'cache_control_matrix (4 flagship-sized gates)': part_launches,
            'concatenate (4 flagship-sized gates)': compose_launches,
            'from scratch, default route (52-segment train)':
                scratch_launches}


def clifford_train(device):
    """bench.py's config_clifford_train: 24 distinct pulses of 1-3
    segments with cached filter functions, and the train of 10^4
    positions drawn from them (default_rng(11)); returns (train,
    omega)."""
    n_pulses, n_omega = TRAIN_SHAPE
    X, Y, Z = fft.util.paulis[1:]
    omega = np.geomspace(1e-2, 1e2, n_omega)
    rng = np.random.default_rng(11)
    seg_counts = 1 + rng.integers(0, 3, 24)
    base_coeffs = [np.pi * rng.standard_normal((2, n)) for n in seg_counts]
    base_dt = [0.5 + rng.random(n) for n in seg_counts]
    train_idx = rng.integers(0, 24, n_pulses)
    distinct = []
    for c, dt in zip(base_coeffs, base_dt):
        p = fft.PulseSequence([[X / 2, c[0], 'X'], [Y / 2, c[1], 'Y']],
                              [[Z / 2, np.ones(len(dt)), 'Z']], dt,
                              device=device)
        p.cache_filter_function(omega)
        distinct.append(p)
    return [distinct[i] for i in train_idx], omega


def concat_small(device, card) -> int:
    """Phase 9d: bench.py's small-d configurations; returns the kernel's
    launches (none of these pulses is deep)."""
    dword.launches = 0
    X, Y, Z = fft.util.paulis[1:]

    # concat_train
    n_pulses, n_omega = TRAIN_SHAPE
    omega = np.geomspace(1e-2, 1e2, n_omega)
    not_pulse = fft.PulseSequence([[X / 2, [np.pi], 'X']],
                                  [[Z / 2, [1], 'Z']], [1], device=device)
    not_pulse.cache_filter_function(omega)
    periodic = fft.concatenate_periodic(not_pulse, n_pulses)
    uniform = fft.concatenate([not_pulse] * n_pulses)
    pair = [not_pulse, copy.copy(not_pulse)] * (n_pulses // 2)
    general = fft.concatenate(pair)
    f_per = periodic.get_filter_function(omega)
    parity = _rel(uniform.get_filter_function(omega), f_per)
    parity_general = _rel(general.get_filter_function(omega), f_per)
    print(f'concat train: {n_pulses} cached NOT pulses, {n_omega} '
          f'frequencies: concatenate([p] * n) against concatenate_periodic '
          f'{parity:.3e}; the general path on two alternating objects '
          f'{parity_general:.3e} of the largest entry (bound '
          f'{LONG_TRAIN_PARITY})')
    _check('concat_train, closed form', parity, LONG_TRAIN_PARITY)
    _check('concat_train, general path', parity_general, LONG_TRAIN_PARITY)
    ms = _median_ms(lambda: fft.concatenate([not_pulse] * n_pulses), N_TIMED)
    ms_general = _median_ms(lambda: fft.concatenate(pair), N_TIMED)
    print(f'timing: concat train {ms:.4f} ms per train (closed form), '
          f'{ms_general:.4f} ms on the general path (median of {N_TIMED}) '
          f'[{card}]')

    # clifford_train
    train, omega = clifford_train(device)
    big = fft.concatenate(train)
    cpu_train, _ = clifford_train('cpu')
    to_cpu = _rel(big.get_filter_function(omega).cpu(),
                  fft.concatenate(cpu_train).get_filter_function(omega))
    print(f'clifford train: 24 distinct cached pulses at {len(train)} '
          f'positions ({len(big)} segments): filter function against the '
          f'CPU {to_cpu:.3e} of the largest entry (bound '
          f'{CLIFFORD_TRAIN_PARITY})')
    _check('clifford_train against the CPU', to_cpu, CLIFFORD_TRAIN_PARITY)
    ms = _median_ms(lambda: fft.concatenate(train), N_TIMED)
    print(f'timing: clifford train {ms:.4f} ms per train (median of '
          f'{N_TIMED}) [{card}]')

    # dd
    n, n_omega, batch = DD_SHAPE
    tau = np.pi
    omega = np.logspace(0, 2, n_omega)
    for dd_type, closed in (('cpmg', analytic.CPMG), ('udd', analytic.UDD)):
        pulse = dd.dd_pulse(n, tau=tau, tau_pi=1e-9, dd_type=dd_type,
                            device=device)
        got = pulse.get_filter_function(omega)[0, 0].real.cpu().numpy()
        err = np.abs(got - closed(omega * tau, n) / omega**2).max()
        print(f'dd: {dd_type.upper()}-{n} at {n_omega} frequencies against '
              f'the closed form: max |FF - closed form| {err:.3e} (bound '
              f'{DD_PARITY})')
        _check(f'dd {dd_type}', err, DD_PARITY)
    base = functional.make_pulse_arrays(
        dd.dd_pulse(n, tau=tau, tau_pi=1e-9, device=device))
    scales = torch.from_numpy(
        1 + 0.1 * np.random.default_rng(0).random(batch)).to(device)
    p = base._replace(c_coeffs=base.c_coeffs / scales[:, None, None],
                      n_coeffs=base.n_coeffs.expand(batch, -1, -1),
                      dt=base.dt * scales[:, None])
    omega_dev = torch.from_numpy(omega).to(device)
    ms = _median_ms(lambda: functional.fidelity_filter_function(p, omega_dev),
                    N_TIMED)
    print(f'timing: dd {ms / batch:.4f} ms/pulse (CPMG-{n} at {batch} '
          f'durations, filter function at {n_omega} frequencies, median of '
          f'{N_TIMED}) [{card}]')

    # rb
    n_seq, length, n_omega = RB_SHAPE
    rng = np.random.default_rng(0)
    seqs = []
    for _ in range(n_seq):
        idx, rec = rb.sample_sequence(length, rng)
        seqs.append(idx + [rec])
    omega = np.geomspace(1e-2, 1e2, n_omega)
    spectrum = 1e-3 / omega
    got = rb.batched_rb_infidelities(seqs, omega, spectrum, device=device)
    pulses = rb.clifford_pulses(omega=omega, device=device)
    want = torch.stack([fft.infidelity(
        rb.rb_pulse(s[:-1], s[-1], pulses), spectrum, omega)[0]
        for s in seqs[:4]])
    err = ((got[:4] - want).abs() / want).max().item()
    print(f'rb: {n_seq} sequences of {length} Cliffords plus recovery, '
          f'{n_omega} frequencies: batched against rb_pulse by concatenate '
          f'on 4 sequences {err:.3e} relative (bound {CONCAT_PARITY}); mean '
          f'infidelity {got.mean().item():.6e}')
    if not torch.isfinite(got).all():
        raise AssertionError('rb: infidelities not finite')
    _check('rb against concatenate', err, CONCAT_PARITY)
    ms = _median_ms(lambda: rb.batched_rb_infidelities(
        seqs, omega, spectrum, device=device), N_TIMED)
    print(f'timing: rb {ms / n_seq:.6f} ms/sequence ({ms:.4f} ms per call of '
          f'{n_seq}, median of {N_TIMED}) [{card}]')
    return dword.launches


def concat_second_order(device, card) -> int:
    """Phase 9e: K11 on two pulses at config_second_order's shapes;
    returns the kernel's launches (d = 4 is not deep)."""
    _, host, basis, omega, _ = second_order_inputs(device)
    dword.launches = 0
    pulses = [fft.PulseSequence.from_arrays(
        host['c_opers'], ['A', 'B'], host['c_coeffs'][b], host['n_opers'],
        ['a', 'b'], host['n_coeffs'][b], host['dt'][b], basis=basis,
        device=device) for b in (0, 1)]

    def compose():
        for p in pulses:
            p.cleanup('all')
            p.cache_filter_function(omega, cache_intermediates=True)
            p.cache_filter_function(omega, order=2, cache_intermediates=True)
        return fft.concatenate(pulses, calc_second_order_FF=True)

    train = compose()
    got = train.get_filter_function(omega, order=2)
    scratch = fft.concatenate_without_filter_function(pulses)
    err = _rel(got, scratch.get_filter_function(omega, order=2))
    print(f'concat second order: 2 pulses of 8 segments, d = 4, '
          f'{len(omega)} frequencies: K11 {tuple(got.shape)} against the '
          f'{len(train)}-segment pulse from scratch {err:.3e} of the '
          f'largest entry (bound {CONCAT_PARITY})')
    if not torch.isfinite(got).all():
        raise AssertionError('K11 is not finite')
    _check('K11 against K10', err, CONCAT_PARITY)
    print(f'timing: concat second order {_median_ms(compose, N_TIMED):.4f} '
          f'ms per cold composition (both parts\' second-order caches, then '
          f'K11; median of {N_TIMED}) [{card}]')
    return dword.launches


def _extend_parts(device):
    """Phase 10a's two d = 4 parts (their host Hamiltonians from
    default_rng(8)), the register pulse built explicitly on *device*,
    the additional noise Hamiltonian and the register's identifiers of
    the crosstalk operators and of the Z rows they correlate with."""
    I2, X, Y, Z = util.paulis
    dt = qft.qft_pulse_sequence(4, device='cpu').dt
    n_dt = len(dt)
    rng = np.random.default_rng(8)
    local = {'Xa': (X, I2), 'Xb': (I2, X), 'Ya': (Y, I2), 'Yb': (I2, Y)}
    noise = {f'{p}{q}': (P, I2) if q == 'a' else (I2, P)
             for p, P in zip('XYZ', (X, Y, Z)) for q in 'ab'}
    parts, H_c, H_n = [], [], []
    for qubits in ((0, 2), (3, 1)):
        amps = rng.standard_normal((5, n_dt))
        ops = {name: util.tensor(*pair) / 2 for name, pair in local.items()}
        ops['J'] = (util.tensor(X, X) + util.tensor(Y, Y)) / 4
        parts.append(fft.PulseSequence(
            [[op, a, name] for (name, op), a in zip(ops.items(), amps)],
            [[util.tensor(*pair) / 2, np.ones(n_dt), name]
             for name, pair in noise.items()],
            dt, basis.Basis.pauli(2), device=device))

        def on_register(pair):
            factors = [I2] * 4
            for q, P in zip(qubits, pair):
                factors[q] = P
            return util.tensor(*factors)
        suffix = ''.join(map(str, sorted(qubits)))
        for (name, pair), a in zip(local.items(), amps):
            H_c.append([on_register(pair) / 2, a, f'{name}_{suffix}'])
        H_c.append([(on_register((X, X)) + on_register((Y, Y))) / 4,
                    amps[4], f'J_{suffix}'])
        for name, pair in noise.items():
            H_n.append([on_register(pair) / 2, np.ones(n_dt),
                        f'{name}_{suffix}'])
    extra, pairs = [], []
    for i in range(3):
        zz = [I2] * 4
        zz[i] = zz[i + 1] = Z
        z = [I2] * 4
        z[i] = Z
        extra.append([util.tensor(*zz) / 4 + util.tensor(*z) / 2,
                      np.ones(n_dt), f'ZZ{i}{i + 1}'])
        # the part and its qubit that hold register qubit i
        pairs.append((f'ZZ{i}{i + 1}', {0: 'Za_02', 1: 'Zb_13',
                                        2: 'Zb_02'}[i]))
    explicit = fft.PulseSequence(H_c, H_n + extra, dt,
                                 basis.Basis.pauli(4), device=device)
    return parts, explicit, extra, pairs


def _extend(parts, extra):
    return fft.extend([(parts[0], (0, 2)), (parts[1], (3, 1))],
                      additional_noise_Hamiltonian=extra)


def _rows(pulse, identifiers) -> np.ndarray:
    return util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                             identifiers)


def extend_flagship(device, card):
    """Phase 10a: extend at the flagship's width; returns the extended
    pulse and the kernel's launches by what made them."""
    omega, _ = _omega_spectrum(device)
    parts, explicit, extra, pairs = _extend_parts(device)
    dword.launches = 0
    for part in parts:
        part.cache_filter_function(omega)
    torch.cuda.synchronize()
    part_launches = dword.launches
    torch.cuda.reset_peak_memory_stats(device)
    dword.launches = 0
    ext = _extend(parts, extra)
    torch.cuda.synchronize()
    launches = dword.launches
    peak = torch.cuda.max_memory_allocated(device)
    same = all(np.array_equal(getattr(ext, f), getattr(explicit, f))
               for f in ('c_opers', 'c_oper_identifiers', 'c_coeffs',
                         'n_opers', 'n_oper_identifiers', 'n_coeffs', 'dt'))
    prop = (ext.total_propagator - explicit.total_propagator).abs().max() \
        .item()
    extra_ids = [e[2] for e in extra]
    part_ids = [i for i in ext.n_oper_identifiers if i not in extra_ids]
    ctrl = ext.get_control_matrix(omega)
    native = _native_control_matrix(explicit, omega)
    rows, extra_rows = _rows(ext, part_ids), _rows(ext, extra_ids)
    to_parts = _rel(ctrl[rows], native[rows])
    to_extra = _rel(ctrl[extra_rows], native[extra_rows])
    cached = ext.get_filter_function(omega)
    identity = _rel(cached, numeric.calculate_filter_function(ctrl))
    native_ff = numeric.calculate_filter_function(native)
    to_explicit = _rel(cached, native_ff)
    cross = [(int(_rows(ext, [a])[0]), int(_rows(ext, [b])[0]))
             for a, b in pairs]
    cross_min = min(native_ff[a, b].abs().max().item() for a, b in cross)
    to_cross = max((cached[a, b] - native_ff[a, b]).abs().max().item()
                   for a, b in cross) / native_ff.abs().max().item()
    n = len(ext.n_opers)
    spectrum = torch.zeros((n, n, len(omega)), dtype=torch.float64,
                           device=device)
    spectrum[torch.arange(n), torch.arange(n)] = 1e-4 / omega
    for a, b in cross:
        spectrum[a, b] = spectrum[b, a] = 5e-5 / omega
    infid = fft.infidelity(ext, spectrum, omega)
    explicit.cache_control_matrix(omega, native)
    infid_explicit = fft.infidelity(explicit, spectrum, omega)
    to_infid = (infid - infid_explicit).abs().max().item()
    print(f'extend: 2 parts of d = 4, {len(ext)} segments, cached with '
          f'{part_launches} dword_digits launches; extended to N = 4 (d = '
          f'{ext.d}, {len(ext.basis)} Pauli elements, {n} noise operators, '
          f'3 crosstalk) with {launches} launch; operators, identifiers '
          f'and coefficients equal to the explicit pulse\'s: {same}; total '
          f'propagator max |diff| {prop:.3e} (bound {CONCAT_PARITY})')
    print(f'extend: parts\' control-matrix rows against the explicit '
          f'pulse\'s native {to_parts:.3e} of the largest entry (bound '
          f'{CONCAT_PARITY}), crosstalk rows {to_extra:.3e} (bound '
          f'{OZAKI_CTRL_PARITY}); cached filter function against B^H B '
          f'{identity:.3e} (bound {FF_IDENTITY}), against the explicit '
          f'pulse\'s {to_explicit:.3e} (bound {OZAKI_CTRL_PARITY}), on the '
          f'3 cross blocks {to_cross:.3e} (smallest cross block '
          f'{cross_min:.3e}); correlated infidelity against the explicit '
          f'pulse\'s native max |diff| {to_infid:.3e} (bound {PARITY}), '
          f'sum {infid.sum().item():.12e}')
    if part_launches != 0 or launches != 1:
        raise AssertionError(f'launches: parts {part_launches} (expected '
                             f'0), extend {launches} (expected 1)')
    if not same:
        raise AssertionError('the extended pulse is not the explicit one')
    _check('total propagator', prop, CONCAT_PARITY)
    _check('parts\' rows', to_parts, CONCAT_PARITY)
    _check('crosstalk rows', to_extra, OZAKI_CTRL_PARITY)
    _check('filter function against B^H B', identity, FF_IDENTITY)
    _check('filter function against the explicit pulse', to_explicit,
           OZAKI_CTRL_PARITY)
    _check('correlated infidelity', to_infid, PARITY)
    if not cross_min > 0:
        raise AssertionError('a crosstalk operator does not correlate with '
                             'its Z row')

    # the card, with the crosstalk rows native, against the CPU
    extra_native = numeric.calculate_control_matrix_from_scratch(
        ext.eigvals, ext.eigvecs, ext.propagators, omega, ext.basis,
        ext.n_opers[extra_rows], ext.n_coeffs[extra_rows], ext.dt, t=ext.t,
        contract='native')
    on_card = ctrl.clone()
    on_card[extra_rows] = extra_native
    cpu_parts, _, _, _ = _extend_parts('cpu')
    for part in cpu_parts:
        part.cache_filter_function(omega.cpu())
    cpu = _extend(cpu_parts, extra).get_control_matrix(omega.cpu())
    to_cpu = _rel(on_card.cpu(), cpu)
    print(f'extend: the card with the crosstalk rows native against the '
          f'CPU port {to_cpu:.3e} of the largest entry (bound {CPU_PARITY})')
    _check('extend on the card against the CPU', to_cpu, CPU_PARITY)

    dword.launches = 0
    ms = _median_ms(lambda: _extend(parts, extra), N_TIMED)
    timed_launches = dword.launches

    def scratch():
        explicit.cleanup('all')
        explicit.get_control_matrix(omega)
    ms_scratch = _median_ms(scratch, N_TIMED)
    print(f'timing: extend {ms:.4f} ms per cold extend of the cached parts '
          f'({timed_launches} launches in {N_TIMED} calls), explicit '
          f'pulse\'s control matrix from scratch on the default route '
          f'{ms_scratch:.4f} ms (median of {N_TIMED}); peak device memory of '
          f'one extend {peak / 2**30:.2f} GiB [{card}]')
    return ext, {'cache_filter_function (extend\'s two d = 4 parts)':
                 part_launches,
                 'extend (crosstalk rows from scratch, default route)':
                 launches}


def remap_extended(device, card, ext) -> dict:
    """Phase 10b: remap of the extended pulse; returns the kernel's
    launches."""
    omega, _ = _omega_spectrum(device)
    order = (2, 0, 3, 1)
    dword.launches = 0
    remapped = fft.remap(ext, order)
    torch.cuda.synchronize()
    launches = dword.launches
    inv_perm = torch.as_tensor(np.argsort(
        basis.remap_pauli_basis_elements(order, 4)), device=device)
    ctrl = ext.get_control_matrix(omega)
    got = remapped.get_control_matrix(omega)
    equal = torch.equal(got, ctrl[:, inv_perm])
    dims = [[2] * 4] * 2
    opers = np.array_equal(remapped.n_opers, util.tensor_transpose(
        ext.n_opers, order, dims)) and np.array_equal(
        remapped.c_opers, util.tensor_transpose(ext.c_opers, order, dims))
    native = _native_control_matrix(remapped, omega)
    extra_ids = [i for i in remapped.n_oper_identifiers
                 if i.startswith('ZZ')]
    part_ids = [i for i in remapped.n_oper_identifiers
                if i not in extra_ids]
    rows, extra_rows = _rows(remapped, part_ids), _rows(remapped, extra_ids)
    to_parts = _rel(got[rows], native[rows])
    to_extra = _rel(got[extra_rows], native[extra_rows])
    print(f'remap: extended pulse to qubit order {order} with {launches} '
          f'dword_digits launches; cached control matrix equal to the index '
          f'permutation of 10a\'s: {equal}; operators equal to '
          f'tensor_transpose: {opers}; against its native control matrix '
          f'from scratch: parts\' rows {to_parts:.3e} (bound '
          f'{CONCAT_PARITY}), crosstalk rows {to_extra:.3e} (bound '
          f'{OZAKI_CTRL_PARITY})')
    if launches != 0 or not equal or not opers:
        raise AssertionError('remap launched the kernel or is not the '
                             'permutation of the extended pulse')
    _check('remapped parts\' rows', to_parts, CONCAT_PARITY)
    _check('remapped crosstalk rows', to_extra, OZAKI_CTRL_PARITY)
    dword.launches = 0
    ms = _median_ms(lambda: fft.remap(ext, order), N_TIMED)
    print(f'timing: remap {ms:.4f} ms per remap of the cached extended '
          f'pulse (median of {N_TIMED}, {dword.launches} launches) [{card}]')
    return {'remap (extended pulse)': launches + dword.launches}


def cpmg_family(device):
    """Phase 10c's CPMG-8 family as batched PulseArrays on *device*, the
    durations and the frequencies."""
    n_pulses, n_omega, _, _ = SPECTRO_SHAPE
    taus = np.geomspace(0.3, 30, n_pulses)
    pulses = [dd.dd_pulse(8, tau=tau, tau_pi=1e-4, device='cpu')
              for tau in taus]
    base = functional.make_pulse_arrays(pulses[0])
    p = base._replace(
        c_coeffs=torch.from_numpy(np.stack([q.c_coeffs for q in pulses])),
        n_coeffs=base.n_coeffs.expand(n_pulses, -1, -1),
        dt=torch.from_numpy(np.stack([q.dt for q in pulses])))
    p = functional.PulseArrays(*(x.to(device) for x in p))
    omega = torch.from_numpy(np.geomspace(2e-1, 2e2, n_omega)).to(device)
    return p, taus, omega


def spectroscopy_cpmg(device, card) -> int:
    """Phase 10c: noise spectroscopy on a CPMG-8 family; returns the
    kernel's launches."""
    n_pulses, _, n_nodes, n_steps = SPECTRO_SHAPE
    p, taus, omega = cpmg_family(device)
    dword.launches = 0

    def design():
        ffs = functional.fidelity_filter_function(p, omega)[:, 0, 0].real
        return spectroscopy.design_matrix(ffs, omega, n_nodes=n_nodes)
    a, nodes = design()
    s_true = torch.from_numpy(1e-3 / nodes**0.7).to(device)
    infids = a @ s_true

    def solve():
        return spectroscopy.reconstruct(a, infids, ridge=1e-10,
                                        n_steps=n_steps)
    s_hat = solve()
    torch.cuda.synchronize()
    launches = dword.launches
    spectrum = spectroscopy.interpolate_spectrum(s_true, nodes, omega)
    idx = np.linspace(0, n_pulses - 1, 8).astype(int)
    direct = torch.stack([fft.infidelity(
        dd.dd_pulse(8, tau=taus[i], tau_pi=1e-4, device=device), spectrum,
        omega)[0] for i in idx])
    forward = _rel(infids[idx], direct)
    residual = ((a @ s_hat - infids).abs() / infids.abs()).max().item()
    interior = ((s_hat - s_true).abs() / s_true)[1:-2].max().item()
    a_cpu, _ = spectroscopy.design_matrix(
        functional.fidelity_filter_function(
            functional.PulseArrays(*(x.cpu() for x in p)), omega.cpu())
        [:, 0, 0].real, omega.cpu(), n_nodes=n_nodes)
    s_cpu = spectroscopy.reconstruct(a_cpu, a_cpu @ s_true.cpu(),
                                     ridge=1e-10, n_steps=n_steps)
    to_cpu = _rel(s_hat.cpu(), s_cpu)
    print(f'spectroscopy: CPMG-8 at {n_pulses} durations, {len(omega)} '
          f'frequencies, {n_nodes} nodes, {n_steps} FISTA steps: A s against '
          f'fft.infidelity on 8 pulses {forward:.3e} relative (bound 1e-10); '
          f'min s_hat {s_hat.min().item():.3e}; forward residual '
          f'{residual:.3e} (bound 1e-3); interior nodes {interior:.3e} '
          f'(bound 0.15); card against the CPU port {to_cpu:.3e} of the '
          f'largest node (bound {S_HAT_PARITY}); {launches} dword_digits '
          'launches')
    _check('A s against the infidelities', forward, 1e-10)
    if not (s_hat >= 0).all():
        raise AssertionError('the reconstruction is negative')
    _check('forward residual', residual, 1e-3)
    _check('interior nodes', interior, 0.15)
    _check('reconstruction on the card against the CPU', to_cpu,
           S_HAT_PARITY)
    ms_design = _median_ms(design, N_TIMED)
    ms_solve = _median_ms(solve, N_TIMED)
    print(f'timing: spectroscopy design matrix {ms_design:.4f} ms (filter '
          f'functions of {n_pulses} pulses and the trapezoid), solve '
          f'{ms_solve:.4f} ms ({n_steps} steps; median of {N_TIMED}) [{card}]')
    return launches


def exchange_cnot(device, card) -> int:
    """Phase 10d: the exchange model on a .mat file written here; returns
    the kernel's launches."""
    exchange_ops, gradient_ops = exchange.heisenberg_operators(4)
    rng = np.random.default_rng(9)
    with tempfile.TemporaryDirectory() as tmp:
        from scipy import io
        path = Path(tmp) / 'cnot.mat'
        io.savemat(str(path), {
            'eps': rng.normal(0, 1, (3, CNOT_SEGMENTS)),
            't': 0.5 + rng.random(CNOT_SEGMENTS),
            'B': rng.normal(0, 1, 3)})
        pulses = {dev: exchange.cnot_pulse(str(path), device=dev)
                  for dev in (device, 'cpu')}
    infids = {}
    dword.launches = 0
    for dev, pulse in pulses.items():
        pulse.basis = exchange.qubit_subspace_basis()
        pulse.d = 4
        omega = np.geomspace(1 / pulse.tau, 1e2, 250)
        infids[dev] = fft.infidelity(pulse, exchange.dial_spectrum(omega),
                                     omega, ['eps_12', 'eps_23', 'eps_34'])
        if dev == device:
            torch.cuda.synchronize()
            launches = dword.launches
    rel = ((infids[device].cpu() - infids['cpu']).abs()
           / infids['cpu'].abs()).max().item()
    print(f'exchange: heisenberg_operators(4) {exchange_ops.shape} + '
          f'{gradient_ops.shape}; cnot_pulse on a .mat of {CNOT_SEGMENTS} '
          f'random segments (default_rng(9); not the published pulse), d = '
          f'6 (K = 36 x {CNOT_SEGMENTS} = {36 * CNOT_SEGMENTS}): infidelity '
          f'in qubit_subspace_basis() under the Dial spectrum '
          f'{infids[device].cpu().numpy()} against the CPU port '
          f'{rel:.3e} relative (bound 1e-12); {launches} dword_digits '
          f'launches on the card')
    _check('cnot_pulse on the card against the CPU', rel, CPU_PARITY)
    return launches


def _first(p, n):
    """The first *n* pulses of the batch *p*."""
    return p._replace(c_coeffs=p.c_coeffs[:n], n_coeffs=p.n_coeffs[:n],
                      dt=p.dt[:n])


def _full(x, cpu_mesh=None):
    """The full value of the DTensor *x*: its local block on a one-rank
    mesh (a 1 x 1 mesh's 'nccl' group then sets up no communicator);
    else ``full_tensor()`` of the same placements on *cpu_mesh*, a mesh
    of the same ranks on the CPU.  gloo's all-gather of CUDA tensors
    crashes (SIGSEGV) on the card's machine; its all-reduce, which the
    port's collectives use, works."""
    if x.device_mesh.size() == 1:
        return x.to_local()
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local().cpu(), cpu_mesh, x.placements,
                              run_check=False).full_tensor()


def sharded_flagship(device, card, batched, omega, spectrum, infid):
    """Phase 11a: the flagship batch on a one-rank mesh; returns the mesh
    and the kernel's launches by path."""
    mesh = parallel.make_mesh(1, device=device)
    sharding.collectives = []
    dword.launches = 0
    got = parallel.sharded_batched_infidelity(batched, spectrum, omega, mesh,
                                              chunk_size=CHUNK)
    torch.cuda.synchronize()
    launches, reduced = dword.launches, list(sharding.collectives)
    equal = torch.equal(_full(got), infid)
    print(f'sharded flagship: make_mesh(1) on {device}: mesh '
          f'{tuple(mesh.shape)} {mesh.mesh_dim_names}, backend '
          f'{torch.distributed.get_backend()}; sharded_batched_infidelity '
          f'batch {BATCH} chunk {CHUNK}: equal to phase 4 {equal}, '
          f'collectives {reduced}, dword_digits launches {launches}')
    if not equal or reduced or launches != BATCH // CHUNK:
        raise AssertionError('the one-rank sharded flagship is not phase 4')
    ms = _median_ms(lambda: parallel.sharded_batched_infidelity(
        batched, spectrum, omega, mesh, chunk_size=CHUNK), N_TIMED)
    plain = _median_ms(lambda: functional.batched_infidelity(
        batched, spectrum, omega, chunk_size=CHUNK), N_TIMED)
    print(f'timing: sharded_batched_infidelity (one-rank mesh) '
          f'{ms / BATCH:.4f} ms/pulse, functional.batched_infidelity '
          f'{plain / BATCH:.4f} ms/pulse (median of {N_TIMED}, batch '
          f'{BATCH}, chunk {CHUNK}) [{card}]')
    return mesh, {'parallel.sharded_batched_infidelity (one-rank mesh)':
                  launches}


def dryrun_inputs(n_ranks, device):
    """The dry run's problem for *n_ranks* ranks (``entry.dryrun_problem``,
    __graft_entry__.dryrun_multichip's): (mesh batch axis, PulseArrays,
    omega, spectrum) on *device*."""
    batch_axis, arrays, omega, spectrum = entry.dryrun_problem(n_ranks)
    return (batch_axis, convert.pulse_arrays_from_numpy(arrays, device=device),
            torch.from_numpy(omega).to(device),
            torch.from_numpy(spectrum).to(device))


def dryrun_grape(mesh, n_ranks, device, cpu_mesh=None):
    """Two grape_step calls and sharded_batched_infidelity on the dryrun
    problem: (loss before, loss after the first step, infidelities, the
    collectives of a step, kernel launches); *cpu_mesh* as in
    :func:`_local`."""
    _, p, omega, spectrum = dryrun_inputs(n_ranks, device)
    dword.launches = 0
    sharding.collectives = []
    c1, loss0 = parallel.grape_step(p.c_coeffs, p, spectrum, omega, mesh,
                                    learning_rate=1e-3)
    reduced = list(sharding.collectives)
    _, loss1 = parallel.grape_step(c1, p, spectrum, omega, mesh,
                                   learning_rate=1e-3)
    infids = _full(parallel.sharded_batched_infidelity(p, spectrum, omega,
                                                        mesh), cpu_mesh)
    torch.cuda.synchronize()
    return (_full(loss0, cpu_mesh).item(), _full(loss1, cpu_mesh).item(),
            infids.cpu(), reduced, dword.launches)


def _check_dryrun(name, loss0, loss1, infids):
    print(f'{name}: grape_step loss {loss0:.12e} -> {loss1:.12e}, '
          f'sharded_batched_infidelity {tuple(infids.shape)} finite '
          f'{bool(torch.isfinite(infids).all())}')
    if not (np.isfinite(loss0) and np.isfinite(loss1) and loss1 < loss0
            and torch.isfinite(infids).all()):
        raise AssertionError(f'{name}: the loss is not finite and falling')


def _rank_11b():
    """One rank of phase 11b: its results, collectives and kernel
    launches by call."""
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    batched, omega, spectrum = flagship_inputs(device)
    p = _first(batched, GRAD_BATCH)
    one = p._replace(c_coeffs=p.c_coeffs[0], n_coeffs=p.n_coeffs[0],
                     dt=p.dt[0])
    out, meshes = {}, {}
    for shape in ((1, 2), (2, 1)):
        mesh = parallel.make_mesh(2, batch=shape[0], device=device)
        cpu_mesh = parallel.make_mesh(2, batch=shape[0], device='cpu')
        meshes[shape] = mesh, cpu_mesh
        calls = {'batched': lambda: parallel.sharded_batched_infidelity(
                     p, spectrum, omega, mesh, chunk_size=CHUNK),
                 'ff': lambda: parallel.sharded_filter_function(
                     one, omega, mesh)}
        for name, call in calls.items():
            sharding.collectives = []
            dword.launches = 0
            result = call()
            torch.cuda.synchronize()
            out[shape, name] = (_full(result, cpu_mesh),
                                list(sharding.collectives),
                                dword.launches)
        # autograd: the sum of the rank's rows (8a's loss), backpropagated
        c = p.c_coeffs.detach().clone().requires_grad_(True)
        sharding.collectives = []
        dword.launches = 0
        result = parallel.sharded_batched_infidelity(
            p._replace(c_coeffs=c), spectrum, omega, mesh, chunk_size=CHUNK)
        forward = (list(sharding.collectives), dword.launches)
        sharding.collectives = []
        dword.launches = 0
        result.to_local().sum().backward()
        torch.cuda.synchronize()
        out[shape, 'backward'] = (c.grad.cpu(), mesh.get_coordinate()[0],
                                  forward, (list(sharding.collectives),
                                            dword.launches))
    mesh, cpu_mesh = meshes[2, 1]
    out['dryrun'] = dryrun_grape(mesh, 2, device, cpu_mesh)
    # 12b: the rank function of entry.dryrun_multichip(2) in this group
    t0 = time.perf_counter()
    out['entry dryrun'] = entry._dryrun_rank(2, 'cuda')
    torch.cuda.synchronize()
    out['entry dryrun seconds'] = time.perf_counter() - t0
    return out


def two_ranks(device, card, batched, omega, infid, grad_8a) -> dict:
    """Phase 11b: two spawned ranks on cuda:0; returns the kernel's
    launches of both ranks by path."""
    print('two ranks: NCCL refuses two ranks on one card, so both ranks '
          'run on cuda:0 over gloo (FileStore); gloo all-reduces CUDA '
          'tensors but its all-gather of them crashes, so each rank gathers '
          'a result with full_tensor() on a CPU mesh of the same ranks')
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel_ranks.run_ranks(_rank_11b, 2, backend='gloo',
                                     deadline=RANK_DEADLINE)
    print(f'two ranks: both exited 0 after {time.perf_counter() - t0:.1f} s '
          f'(spawn and start-up included)')

    p = _first(batched, GRAD_BATCH)
    one = p._replace(c_coeffs=p.c_coeffs[0], n_coeffs=p.n_coeffs[0],
                     dt=p.dt[0])
    ff_want = functional.fidelity_filter_function(one, omega).cpu()
    rows_want = infid[:GRAD_BATCH].cpu()
    expected = {((1, 2), 'batched'): ([('max', None), ('sum', 'omega')], 2),
                ((1, 2), 'ff'): ([('max', 'omega')], 1),
                ((2, 1), 'batched'): ([('max', None)], 1),
                ((2, 1), 'ff'): ([], 1)}
    launches = {}
    for key, (want_reduced, want_launches) in expected.items():
        (shape, name) = key
        got = [r[key] for r in ranks]
        if name == 'batched':
            err = ((got[0][0] - rows_want).abs() / rows_want.abs()).max()
            bound, what = SHARD_PARITY, 'against phase 4 rows 0-3, relative'
        else:
            err = (got[0][0] - ff_want).abs().max() / ff_want.abs().max()
            bound = SHARD_FF_PARITY
            what = (f'against the unsharded filter function (equal '
                    f'{torch.equal(got[0][0], ff_want)}), relative')
        print(f'two ranks {shape[0]} x {shape[1]} {name}: {what} '
              f'{err.item():.3e} (bound {bound}); collectives '
              f'{[g[1] for g in got]}; dword_digits launches per rank '
              f'{[g[2] for g in got]}')
        _check(f'two ranks {shape} {name}', err.item(), bound)
        if not torch.equal(got[0][0], got[1][0]):
            raise AssertionError(f'{key}: the ranks disagree')
        if any(g[1] != want_reduced or g[2] != want_launches for g in got):
            raise AssertionError(f'{key}: collectives or launches are not '
                                 f'{want_reduced}, {want_launches}')
        path = ('parallel.sharded_batched_infidelity' if name == 'batched'
                else 'parallel.sharded_filter_function')
        launches[f'{path} (two ranks, {shape[0]} x {shape[1]})'] = sum(
            g[2] for g in got)
    dry_total = 0
    for rank, r in enumerate(ranks):
        loss0, loss1, infids, reduced, dry_launches = r['dryrun']
        _check_dryrun(f'two ranks dryrun 2 x 1, rank {rank}', loss0, loss1,
                      infids)
        if reduced != [('max', None), ('sum', 'batch')] or dry_launches:
            raise AssertionError(f'dryrun on two ranks: collectives '
                                 f'{reduced}, launches {dry_launches}')
        dry_total += dry_launches
    print(f'two ranks dryrun: the collectives of a grape_step {reduced} '
          f'[{card}]')
    launches['parallel.grape_step (dryrun, two ranks)'] = dry_total
    launches['entry.dryrun_multichip (rank function, two ranks, K = 12)'] = \
        entry_dryrun(card, ranks)
    backward_reduced = {(1, 2): [('sum', 'omega')], (2, 1): []}
    forward_reduced = {(1, 2): [('max', None), ('sum', 'omega')],
                       (2, 1): [('max', None)]}
    for shape in ((1, 2), (2, 1)):
        rows = GRAD_BATCH // shape[0]
        errs, for_launches = [], 0
        for r in ranks:
            grad, b, (forward, f_launches), (backward, b_launches) = \
                r[shape, 'backward']
            block = slice(b * rows, (b + 1) * rows)
            want = grad_8a[block].cpu()
            errs.append(_rel(grad[block], want))
            rest = torch.ones(GRAD_BATCH, dtype=torch.bool)
            rest[block] = False
            if grad[rest].any():
                raise AssertionError(f'11b {shape}: a gradient outside the '
                                     'rank\'s rows')
            if (forward != forward_reduced[shape] or b_launches
                    or backward != backward_reduced[shape]):
                raise AssertionError(
                    f'11b {shape} autograd: collectives {forward} forward, '
                    f'{backward} backward, {b_launches} backward launches')
            for_launches += f_launches
        print(f'two ranks {shape[0]} x {shape[1]} autograd: each rank\'s rows '
              f'of c_coeffs.grad against phase 8a {[f"{e:.3e}" for e in errs]}'
              f' relative (bound {SHARD_GRAD_PARITY}); backward collectives '
              f'{backward_reduced[shape]}, dword_digits launches '
              f'{for_launches} forward (both ranks), 0 backward')
        for err in errs:
            _check(f'11b {shape}: the sharded gradient against 8a', err,
                   SHARD_GRAD_PARITY)
        launches[f'parallel.sharded_batched_infidelity (two ranks, '
                 f'{shape[0]} x {shape[1]}, autograd)'] = for_launches
    return launches


def grape_flagship(device, card, mesh, batched, omega, spectrum,
                   grad_8a) -> dict:
    """Phase 11c: GRAPE on the one-rank mesh; returns the kernel's
    launches by path."""
    loss0, loss1, infids, reduced, dry_launches = dryrun_grape(mesh, 1,
                                                              device)
    _check_dryrun('grape dryrun (one rank)', loss0, loss1, infids)
    p = _first(batched, GRAD_BATCH)
    torch.cuda.reset_peak_memory_stats(device)
    sharding.collectives = []
    dword.launches = 0
    new, loss = parallel.grape_step(p.c_coeffs, p, spectrum, omega, mesh,
                                    learning_rate=GRAPE_PROBE_LR,
                                    chunk_size=CHUNK)
    torch.cuda.synchronize()
    launches, step_reduced = dword.launches, list(sharding.collectives)
    peak = torch.cuda.max_memory_allocated(device)
    grad = (p.c_coeffs - _full(new)) / GRAPE_PROBE_LR
    to_8a = _rel(grad, grad_8a)
    print(f'grape flagship: rows 0-{GRAD_BATCH - 1}, chunk {CHUNK}, '
          f'{N_OMEGA} frequencies, route '
          f'{config.contraction_mode(device)!r}: loss '
          f'{_full(loss).item():.12e}, gradient against phase 8a '
          f'{to_8a:.3e} relative (bound {GRAPE_PARITY}); dword_digits '
          f'launches {launches}, collectives {step_reduced}')
    _check('grape_step gradient against phase 8a', to_8a, GRAPE_PARITY)
    if launches != GRAD_BATCH // CHUNK or step_reduced:
        raise AssertionError('grape_step launched or reduced otherwise '
                             'than the forward pass of phase 8a')
    ms = _median_ms(lambda: parallel.grape_step(
        p.c_coeffs, p, spectrum, omega, mesh, chunk_size=CHUNK), N_TIMED)
    print(f'timing: grape_step {ms / GRAD_BATCH:.4f} ms per step per pulse '
          f'(median of {N_TIMED}, batch {GRAD_BATCH}, chunk {CHUNK}); peak '
          f'device memory {peak / 2**30:.2f} GiB [{card}]')

    dword.launches = 0
    t0 = time.perf_counter()
    res = parallel.optimize_pulse(p, spectrum, omega, n_steps=OPTIMIZE_STEPS,
                                  mesh=mesh, chunk_size=CHUNK)
    history = _full(res.history)
    final = _full(res.infidelity)
    torch.cuda.synchronize()
    opt_ms = (time.perf_counter() - t0) * 1e3
    opt_launches = dword.launches
    print(f'grape flagship: optimize_pulse {OPTIMIZE_STEPS} steps (Adam, lr '
          f'1e-2): history {history.tolist()}, final infidelity '
          f'{final.tolist()}; dword_digits launches {opt_launches}; '
          f'{opt_ms:.1f} ms [{card}]')
    if (history.shape != (OPTIMIZE_STEPS,) or final.shape != (GRAD_BATCH,)
            or not torch.isfinite(history).all()
            or not torch.isfinite(final).all()
            or opt_launches != (OPTIMIZE_STEPS + 1) * GRAD_BATCH // CHUNK):
        raise AssertionError('optimize_pulse on the flagship rows')
    return {'parallel.grape_step (dryrun, one rank)': dry_launches,
            'parallel.grape_step (flagship rows 0-3)': launches,
            f'parallel.optimize_pulse (flagship rows 0-3, {OPTIMIZE_STEPS} '
            'steps)': opt_launches}


def entry_flagship(device, card, ozaki_row0, native_row0) -> int:
    """Phase 12a: the port's ``entry()`` on the card; returns the kernel's
    launches in one call."""
    fn, args = entry.entry()
    torch.cuda.reset_peak_memory_stats(device)
    dword.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    launches = dword.launches
    peak = torch.cuda.max_memory_allocated(device)
    if (out.shape != (18,) or out.dtype != torch.float64
            or out.device != device or not torch.isfinite(out).all()):
        raise AssertionError(f'entry(): bad result {tuple(out.shape)} '
                             f'{out.dtype} on {out.device}')
    to_ozaki = ((out - ozaki_row0).abs() / ozaki_row0.abs()).max().item()
    to_native = (out - native_row0).abs().max().item()
    print(f'entry: fn(*args) of entry() on {out.device}, route '
          f'{config.contraction_mode(out.device)!r}: against phase 4 Ozaki '
          f'row 0 {to_ozaki:.3e} relative (bound {OBJECT_PARITY}), native '
          f'row 0 max |diff| {to_native:.3e} (bound {PARITY}); dword_digits '
          f'launches {launches}')
    _check('12a: entry() against phase 4 Ozaki row 0', to_ozaki,
           OBJECT_PARITY)
    _check('12a: entry() against phase 4 native row 0', to_native, PARITY)
    dword.launches = 0
    ms = _median_ms(lambda: fn(*args), N_TIMED)
    if launches != 1 or dword.launches != N_TIMED:
        raise AssertionError(f'entry(): {launches} launches in one call, '
                             f'{dword.launches} in {N_TIMED}: not 1 a call')
    print(f'timing: entry() step {ms:.4f} ms per call (median of '
          f'{N_TIMED}); peak device memory {peak / 2**30:.3f} GiB [{card}]')
    return launches


def entry_dryrun(card, ranks) -> int:
    """Phase 12b: the ranks' results of ``entry._dryrun_rank(2, 'cuda')``,
    the rank function of ``entry.dryrun_multichip(2)``, run in phase 11b's
    two ranks; returns their kernel launches (K = 12 is not deep: 0)."""
    errs = []
    launches = [r['entry dryrun']['launches'] for r in ranks]
    for rank, r in enumerate(ranks):
        got = r['entry dryrun']
        loss0, _, infids, _, _ = r['dryrun']
        rows = infids[2 * rank:2 * rank + 2]
        errs.append(max(abs(got['loss'] - loss0) / abs(loss0),
                        _rel(torch.from_numpy(got['infidelity']), rows)))
        if got['mesh'] != (2, 1) or got['coordinate'] != (rank, 0):
            raise AssertionError(f'12b rank {rank}: mesh {got["mesh"]}, '
                                 f'coordinate {got["coordinate"]}')
        if got['launches']:
            raise AssertionError(f'12b rank {rank}: {got["launches"]} '
                                 'kernel launches on the K = 12 problem')
    print(f'dryrun card: entry._dryrun_rank(2, \'cuda\') in the two ranks of '
          f'11b on cuda:0 over gloo (the spawn of 11b), '
          f'{[round(r["entry dryrun seconds"], 3) for r in ranks]} s per rank;'
          f' loss and infidelities against 11b\'s dryrun on the same mesh '
          f'{[f"{e:.3e}" for e in errs]} relative (bound {SHARD_PARITY}); '
          f'dword_digits launches {launches} [{card}]')
    for err in errs:
        _check('12b: the entry dry run against 11b\'s', err, SHARD_PARITY)
    return sum(launches)


def _cpmg_300(device):
    """The CPMG-300 train of tests/test_torch_accuracy_policy.py on
    *device*: (PulseSequence, a batch of it and of its 1e-7 perturbation,
    omega, spectrum)."""
    pulse = dd.dd_pulse(300, tau=10, tau_pi=1e-2, device=device)
    p = functional.make_pulse_arrays(pulse)
    pb = p._replace(c_coeffs=torch.stack([p.c_coeffs,
                                          p.c_coeffs * 1.0000001]),
                    n_coeffs=p.n_coeffs.expand(2, -1, -1),
                    dt=p.dt.expand(2, -1))
    omega = torch.from_numpy(np.geomspace(1e-4, 1e2, 100)).to(device)
    return pulse, pb, omega, 1e-3 / omega**2


def _elementwise(f, want):
    """max |f - want| / |want| elementwise, with a floor of 1e-30 of the
    largest |want|."""
    floor = want.abs().max() * 1e-30
    return ((f - want).abs() / want.abs().clamp_min(floor)).max().item()


def cpmg_pathology(device, card) -> dict:
    """Phase 12c: the CPMG-300 train on the default route, which must
    escalate, through ``batched_infidelity`` and the object path; returns
    the kernel's launches by path."""
    pulse, pb, omega, spectrum = _cpmg_300(device)
    _, pb_cpu, omega_cpu, spectrum_cpu = _cpmg_300('cpu')
    route = config.contraction_mode(device)
    dword.launches = 0
    got = functional.batched_infidelity(pb, spectrum, omega)
    torch.cuda.synchronize()
    launches = dword.launches
    _, ratios = functional._batched_stat(pb, spectrum, omega, None, 'stat',
                                         route)
    stat = ratios.max().item()
    fast = functional.batched_infidelity(pb, spectrum, omega,
                                         escalation_tol=0)
    native = functional.batched_infidelity(pb, spectrum, omega,
                                           contract='native')
    cpu = functional.batched_infidelity(pb_cpu, spectrum_cpu, omega_cpu,
                                        contract='native')
    scale = native.abs().max()
    to_native = ((got - native).abs().max() / scale).item()
    to_cpu = ((got.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    fast_off = ((fast - native).abs().max() / scale).item()
    print(f'cpmg-300 batched: route {route!r}, K = '
          f'{pulse.d**2 * len(pulse.dt)}, statistic {stat:.6e} (threshold '
          f'{config.ESCALATION_TOL}), dword_digits launches {launches} '
          f'(the stat pass); escalated against the card\'s native '
          f'{to_native:.3e}, the CPU\'s {to_cpu:.3e} (bound '
          f'{ESCALATED_PARITY}); unescalated {fast_off:.3e} off native, '
          f'relative to the largest infidelity')
    if not (stat > config.ESCALATION_TOL and launches == 1):
        raise AssertionError('12c: the CPMG-300 batch did not launch the '
                             'kernel once and escalate')
    _check('12c: escalated batch against native', to_native,
           ESCALATED_PARITY)
    _check('12c: escalated batch against the CPU', to_cpu, ESCALATED_PARITY)
    calls = {name: functools.partial(functional.batched_infidelity, pb,
                                     spectrum, omega, **kw)
             for name, kw in (('escalated (default)', {}),
                              ('unescalated', dict(escalation_tol=0)),
                              ('native', dict(contract='native')))}
    for name, (median, q1, q3) in _in_turns_ms(calls,
                                               ESCALATION_ROUNDS).items():
        print(f'timing: cpmg-300 batched_infidelity {name} {median:.4f} ms '
              f'per call of 2 (median of {ESCALATION_ROUNDS} in turns with '
              f'the others; quartiles {q1:.4f}, {q3:.4f}) [{card}]')

    dword.launches = 0
    f_got = pulse.get_filter_function(omega).real
    torch.cuda.synchronize()
    object_launches = dword.launches
    f_native = numeric.calculate_filter_function(
        _native_control_matrix(pulse, omega), 'fidelity').real
    f_cpu = dd.dd_pulse(300, tau=10, tau_pi=1e-2, device='cpu') \
        .get_filter_function(omega_cpu).real
    tol = config.ESCALATION_TOL
    config.ESCALATION_TOL = 0
    try:
        pulse.cleanup('all')
        f_fast = pulse.get_filter_function(omega).real
    finally:
        config.ESCALATION_TOL = tol
    obj_native = _elementwise(f_got, f_native)
    # the card against the CPU relative to the largest entry: at the
    # train's refocusing points |F| is ~1e-11 of its largest entry, so
    # two summation orders differ there elementwise by ~eps 1e11
    obj_cpu = ((f_got.cpu() - f_cpu).abs().max() / f_cpu.abs().max()).item()
    obj_fast = _elementwise(f_fast, f_native)
    print(f'cpmg-300 object path: get_filter_function, dword_digits '
          f'launches {object_launches}; escalated against the card\'s '
          f'native {obj_native:.3e} elementwise relative, the CPU\'s '
          f'{obj_cpu:.3e} relative to the largest entry '
          f'({_elementwise(f_got.cpu(), f_cpu):.3e} elementwise) (bound '
          f'{ESCALATED_PARITY}); the card\'s native against the CPU\'s '
          f'native, no escalation, {_elementwise(f_native.cpu(), f_cpu):.3e} '
          f'elementwise; unescalated {obj_fast:.3e} elementwise')
    if object_launches != 1 or not obj_fast > ESCALATED_PARITY:
        raise AssertionError('12c: the object path did not launch the '
                             'kernel once, or its fast pass is not off')
    _check('12c: escalated filter function against native', obj_native,
           ESCALATED_PARITY)
    _check('12c: escalated filter function against the CPU', obj_cpu,
           ESCALATED_PARITY)

    def cold():
        pulse.cleanup('all')
        pulse.get_filter_function(omega)
    print(f'timing: cpmg-300 object path {_median_ms(cold, N_TIMED):.4f} ms '
          f'per cold call with its escalation (median of {N_TIMED}) '
          f'[{card}]')
    return {'functional.batched_infidelity (CPMG-300, escalated)': launches,
            'PulseSequence.get_filter_function (CPMG-300, escalated)':
            object_launches}


def _load_example(name: str):
    """The module ``examples_torch/<name>.py`` of this checkout."""
    spec = importlib.util.spec_from_file_location(
        f'examples_torch_{name}',
        Path(__file__).resolve().parent / 'examples_torch' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _plain(value):
    """An example's numbers as printable Python values."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, np.ndarray):
        return value.tolist()
    return value


def _numbers(values, prefix=''):
    """(key path, value) of every number of an example's result that is
    neither a timing (a key ending in '_s') nor a diagnostic."""
    for key, value in values.items():
        path = f'{prefix}{key}'
        if str(key).endswith('_s') or key in EXAMPLE_DIAGNOSTICS:
            continue
        if isinstance(value, dict):
            yield from _numbers(value, f'{path}/')
        else:
            yield path, value


def example_on_card(name, values, cpu) -> None:
    """Phase 13's checks of one example's numbers on the card: its own
    invariants, its diagnostics below their bounds, and, where *cpu*
    (the port's CPU run of the example) is given, every number against
    it, within EXAMPLE_PARITY relative, exactly for booleans, integers,
    strings and shapes.  The exceptions: the QFT pulse's infidelity
    takes the Ozaki route on the card (phase 6's 1e-10 per noise
    operator, summed over 18); the second-order shift of the ETM is a
    difference of two ETMs (their 1e-13, absolute); the reconstructed
    spectrum after 2000 FISTA steps is held as phase 10c holds it
    (S_HAT_PARITY of its largest node), and its fit residual and
    recovery error only printed."""
    invariants = {
        'getting_started': ['hadamard'],
        'qft': ['correct_action'],
        'calculating_quantum_processes': ['completely_positive'],
        'advanced_concatenation': ['echo_cached',
                                   'correlations_sum_to_total'],
        'extending_pulses': ['extend_cached', 'remap_cached',
                             'remap_invariant'],
    }.get(name, [])
    for key in invariants:
        if values[key] is not True:
            raise AssertionError(f'13 {name}: {key} is {values[key]}')
    for key, bound in EXAMPLE_DIAGNOSTICS.items():
        if key in values:
            _check(f'13 {name}: {key}', values[key], bound)
    if name == 'calculating_quantum_processes':
        _check('13 calculating_quantum_processes: the Gamma-trace identity',
               abs(values['gamma_trace'] / values['infidelity'] - 1), 1e-12)
    if name == 'optimal_control' and not (
            values['final_loss'] < values['initial_loss']
            and values['improvement'] > 1):
        raise AssertionError(f'13 optimal_control: GRAPE did not lower the '
                             f'infidelity: {values}')
    if cpu is None:
        return
    absolute = {'qft/infidelity': 18 * PARITY,
                'calculating_quantum_processes/second_order_shift':
                ETM_BATCH_PARITY,
                'noise_spectroscopy/s_nodes': S_HAT_PARITY * float(
                    np.abs(cpu.get('s_nodes', 0)).max())}
    skipped = {'noise_spectroscopy/fit_residual',
               'noise_spectroscopy/recovery_median_rel_err'}
    want = dict(_numbers(cpu))
    got = dict(_numbers(values))
    if set(got) != set(want):
        raise AssertionError(f'13 {name}: the card\'s numbers '
                             f'{sorted(got)} are not the CPU\'s')
    worst, held = 0.0, []
    for path, value in got.items():
        key = f'{name}/{path}'
        g, w = np.asarray(value), np.asarray(want[path])
        if key in skipped:
            continue
        if w.dtype.kind not in 'fc':
            if not np.array_equal(g, w):
                raise AssertionError(f'13 {key}: {value} on the card, '
                                     f'{want[path]} on the CPU')
        elif key in absolute:
            diff = float(np.abs(g - w).max())
            held.append(f'{path} {diff:.3e} absolute (bound '
                        f'{absolute[key]:.3e})')
            _check(f'13 {key} against the CPU', diff, absolute[key])
        else:
            rel = float((np.abs(g - w) / np.where(w == 0, 1.0, np.abs(w))
                         ).max())
            worst = max(worst, rel)
            _check(f'13 {key} against the CPU', rel, EXAMPLE_PARITY)
    print(f'13 {name}: against the port\'s CPU run, largest relative '
          f'difference {worst:.3e} (bound {EXAMPLE_PARITY})'
          + ''.join(f'; {h}' for h in held))


def examples_on_card(device, card) -> dict:
    """Phase 13: each ``examples_torch/<name>.main([..., '--device',
    'cuda'])`` in process at its default size (figures, where matplotlib
    imports, under a temporary ``--out``): its numbers, its ms and its
    kernel launches; checked by :func:`example_on_card`, against the
    port's CPU run of the example for all but periodic_driving (its
    numbers are timings and a diagnostic) and optimal_control (300 GRAPE
    steps on the host).  Returns the launches per example."""
    launches = {}
    with tempfile.TemporaryDirectory() as out:
        for name in EXAMPLES:
            module = _load_example(name)
            extra = ['--out', out] if name in EXAMPLE_FIGURES else []
            torch.cuda.synchronize()
            dword.launches = 0
            t0 = time.perf_counter()
            values = module.main(['--device', 'cuda'] + extra)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches[f'examples_torch/{name}.py'] = dword.launches
            print(f'13 {name}: {ms:.1f} ms on the card, dword_digits '
                  f'launches {dword.launches} [{card}]; numbers '
                  f'{_plain(values)}')
            cpu = None
            if name not in ('periodic_driving', 'optimal_control'):
                with contextlib.redirect_stdout(io.StringIO()):
                    cpu = module.main(['--device', 'cpu'] + extra)
            example_on_card(name, values, cpu)
    if not launches['examples_torch/qft.py'] >= 1:
        raise AssertionError('13: the qft example never launched '
                             'dword_digits')
    return launches


if __name__ == '__main__':
    sys.exit(main())
