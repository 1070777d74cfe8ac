"""Smoke run of the PyTorch port (filter_functions_tpu_torch) on one CUDA
card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. card: a CUDA card must be present; prints its name and power limit.
2. build: compiles the CUDA kernel from ``csrc/`` and prints nvcc's
   register / shared-memory / spill report.
3. kernel: ``dword_digits`` on the card against its plain PyTorch
   version on the card, bit-exact, at K, J, C, n_d = 512, 3, 128, 4 and
   at the flagship's 3328, 18, 256, 5 (batch 2, as the main path calls
   it); times both.
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
from filter_functions_tpu_torch import config, functional
from filter_functions_tpu_torch.models import qft
from filter_functions_tpu_torch.ops import _build, dword

N_OMEGA = 1000
BATCH = 32
CHUNK = 2
N_TIMED = 5
#: dword_digits shapes: (K, J, C, n_d, slice_bits, batch).
KERNEL_SHAPES = {'small': (512, 3, 128, 4, 7, 1),
                 'flagship': (3328, 18, 256, 5, 7, CHUNK)}
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


def check_kernel(device, card):
    """Phase 3: kernel against plain version, bit-exact; returns the
    flagship shape's (max_abs_err, kernel ms, plain ms)."""
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
            print(f'kernel flagship: dword_digits {ms:.4f} ms, plain '
                  f'version {plain_ms:.4f} ms per call of {batch} pulses '
                  f'[{card}]')
            result = (err, ms, plain_ms)
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
    kernel_err, kernel_ms, plain_ms = check_kernel(device, card)

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
        times = []
        for _ in range(N_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            functional.batched_infidelity(batched, spectrum, omega,
                                          chunk_size=CHUNK, contract=name)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        per_pulse = statistics.median(times) / BATCH * 1e3
        print(f'timing: {name} route {per_pulse:.4f} ms/pulse (median of '
              f'{N_TIMED}, batch {BATCH}, chunk {CHUNK}) [{card}]')
    print(f'peak device memory: '
          f'{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB')

    # 6. object path
    object_launches = object_path(device, card, native[0], infid[0])

    print(card)
    print(json.dumps({'kernels': [{
        'name': 'dword_digits', 'route': 'cuda',
        'source': 'filter_functions_tpu_torch/csrc/dword_digits.cu',
        'replaces': 'filter_functions_tpu/ops/dword_pallas.py:198',
        'launches': launches + object_launches,
        'launches_by_path': {
            'functional.batched_infidelity': launches,
            'numeric.infidelity (PulseSequence)': object_launches},
        'max_abs_err': kernel_err, 'ms': kernel_ms,
        'plain_ms': plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def object_path(device, card, native_row0, ozaki_row0) -> int:
    """Phase 6: the object API on the flagship; returns the kernel's
    launches in the first call."""
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
    times = []
    for _ in range(N_TIMED):
        pulse.cleanup('all')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fft.infidelity(pulse, spectrum, omega)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f'timing: object path {statistics.median(times) * 1e3:.4f} ms per '
          f'cold call (median of {N_TIMED}, caches cleared before each); '
          f'peak device memory {peak / 2**30:.2f} GiB [{card}]')
    return launches


if __name__ == '__main__':
    sys.exit(main())
