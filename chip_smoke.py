"""Smoke run of the PyTorch port (filter_functions_tpu_torch) on one CUDA
card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. card: a CUDA card must be present; prints its name and power limit.
2. build: compiles the CUDA kernel from ``csrc/`` and prints nvcc's
   register / shared-memory / spill report.
3. kernel: ``dword_digits`` on the card against its plain PyTorch
   version on the card, bit-exact, at the four shapes of
   ``KERNEL_SHAPES``: K, J, C, n_d = 512, 3, 128, 4; the flagship's 3328,
   18, 256, 5 (batch 2, as the main path calls it); a ragged K = 333
   (byte stores); K = 20000, above the kernel's register cap.  Times the
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

Before the last line come the card's label and the kernels' JSON
record, in that order; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import filter_functions_tpu_torch as fft
from filter_functions_tpu_torch import (config, functional, numeric,
                                        superoperator)
from filter_functions_tpu_torch.models import qft
from filter_functions_tpu_torch.ops import _build, dword

N_OMEGA = 1000
BATCH = 32
CHUNK = 2
N_TIMED = 5
#: dword_digits shapes: (K, J, C, n_d, slice_bits, batch).
KERNEL_SHAPES = {'small': (512, 3, 128, 4, 7, 1),
                 'flagship': (3328, 18, 256, 5, 7, CHUNK),
                 'ragged': (333, 2, 9, 5, 7, 3),
                 'above_cap': (20000, 2, 16, 5, 7, 1)}
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
        if name == 'flagship':
            ms = _cuda_ms(lambda: dword.dword_digits(*factors, n_d, sb), 20)
            plain_ms = _cuda_ms(lambda: dword.dword_digits_reference(
                *factors, n_d, sb), 5)
            bound_ms = dword_bound_ms(K, J, C, n_d, batch)
            print(f'kernel flagship: dword_digits {ms:.4f} ms, plain '
                  f'version {plain_ms:.4f} ms per call of {batch} pulses; '
                  f'memory bound {bound_ms:.4f} ms, '
                  f'{100 * bound_ms / ms:.1f} % of it [{card}]')
            result = (err, ms, plain_ms, bound_ms)
    return result


def flagship_inputs(device):
    """bench.py's flagship batch: the QFT pulse in row 0, rows 1-31 with
    control coefficients scaled by 1 + 0.05 N(0, 1) from
    default_rng(0)."""
    p = qft.qft_pulse_arrays(4, device=device)
    rng = np.random.default_rng(0)
    scales = 1 + 0.05 * rng.standard_normal((BATCH, 1, 1))
    scales[0] = 1.0
    batched = p._replace(
        c_coeffs=p.c_coeffs[None] * torch.from_numpy(scales).to(device),
        n_coeffs=p.n_coeffs.expand(BATCH, -1, -1).contiguous(),
        dt=p.dt.expand(BATCH, -1).contiguous())
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

    # 2. build
    t0 = time.perf_counter()
    lib, report = _build.build('dword_digits')
    print(f'build: {lib.name} in {time.perf_counter() - t0:.1f} s '
          '(nvcc -Xptxas -v):')
    print(report.strip())

    # 3. kernel against plain version
    kernel_err, kernel_ms, plain_ms, bound_ms = check_kernel(device, card)

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

    # 6. object path
    object_launches, object_infid = object_path(device, card, native[0],
                                                infid[0])

    # 7. error transfer matrix
    etm_launches = etm_flagship(device, card, object_infid)
    etm_second_order(device, card)

    # 8. gradients
    grad_launches = autograd_flagship(device, card, batched, omega, spectrum)
    analytic_flagship(device, card)
    grad_config(device, card)

    print(card)
    print(json.dumps({'kernels': [{
        'name': 'dword_digits', 'route': 'cuda',
        'source': 'filter_functions_tpu_torch/csrc/dword_digits.cu',
        'replaces': 'filter_functions_tpu/ops/dword_pallas.py:198',
        'launches': launches + object_launches + etm_launches
        + grad_launches,
        'launches_by_path': {
            'functional.batched_infidelity': launches,
            'numeric.infidelity (PulseSequence)': object_launches,
            'numeric.error_transfer_matrix (PulseSequence)': etm_launches,
            'functional.batched_infidelity (autograd)': grad_launches},
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
    routes; returns the kernel's launches in the forward pass."""
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
    return forward


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


if __name__ == '__main__':
    sys.exit(main())
