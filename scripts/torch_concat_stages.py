"""Where the time of concatenation goes on one CUDA card, at the inputs
of chip_smoke.py's phase 9.

For each stage it prints the host time ending in a synchronize (median
of 7, ms), the device time of one run from torch.profiler and the idle
share it implies:

* the live flagship (9a): building the 9 gates of ``qft_pulse(4)``,
  caching their filter functions at 1000 frequencies, the Hamiltonian
  union (``concatenate_without_filter_function``), ``concatenate`` of
  the cached gates, and, beside them, the from-scratch control matrix
  of the composed 13-segment pulse on the native route;
* the periodic train (9b): ``concatenate_periodic`` of the cached
  flagship at 10^4 repeats;
* the long d = 2 trains (9d): the union and ``concatenate`` of
  ``clifford_train``'s 10^4 positions, and the general path of
  ``concat_train`` on two alternating objects.

    python3 scripts/torch_concat_stages.py [PROFILE_TABLES]

With a path, the profiler's tables (12 rows per stage) are written
there.
"""
import copy
import io
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import filter_functions_tpu_torch as fft  # noqa: E402
from filter_functions_tpu_torch.models import qft  # noqa: E402

ROUNDS = 7


def stage(name, fn, card, log, setup=None):
    """Host time (median of ROUNDS after a warm-up), profiler device
    time and idle share of *fn*; *setup* runs untimed before each."""
    times = []
    for _ in range(ROUNDS + 1):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(times[1:])
    if setup is not None:
        setup()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # kernel rows only: an op's row repeats its kernels' device time
    device = sum(e.self_device_time_total for e in averages
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    kernels = sum(e.count for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f'{name}: {wall:.4f} ms (median of {ROUNDS}); profiler device '
          f'time {device:.4f} ms in {kernels} kernels and copies, idle '
          f'share {1 - device / wall:.3f} [{card}]')
    log.write(f'== {name}\n' + averages.table(
        sort_by='self_device_time_total', row_limit=12) + '\n')


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_concat_stages: no CUDA card', file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    card = chip_smoke._card_label()
    log = io.StringIO()
    omega = torch.from_numpy(
        np.geomspace(1e-2, 1e2, chip_smoke.N_OMEGA)).to(device)

    # 9a, the live flagship
    state = {}

    def build():
        state['gates'] = qft._qft_atomic_pulses(4, device=device)

    def cache():
        for gate in state['gates']:
            gate.cache_filter_function(omega)

    def built_and_cached():
        build()
        cache()

    stage('flagship: build 9 gates', build, card, log)
    stage('flagship: cache 9 filter functions', cache, card, log,
          setup=build)
    stage('flagship: Hamiltonian union of 9 gates',
          lambda: fft.concatenate_without_filter_function(state['gates']),
          card, log, setup=built_and_cached)
    stage('flagship: concatenate 9 cached gates',
          lambda: fft.concatenate(state['gates']), card, log,
          setup=built_and_cached)
    live = qft.qft_pulse(4, device=device)
    stage('flagship: from scratch, native route (cold)',
          lambda: chip_smoke._native_control_matrix(live, omega), card, log,
          setup=lambda: live.cleanup('all'))

    # 9b, the periodic train
    pulse = qft.qft_pulse_sequence(4, device=device)
    pulse.cache_filter_function(omega)
    repeats = chip_smoke.TRAIN_REPEATS[1]
    stage(f'periodic: {repeats} repeats of the cached flagship',
          lambda: fft.concatenate_periodic(pulse, repeats), card, log)

    # 9d, the long d = 2 trains
    train, _ = chip_smoke.clifford_train(device)
    stage(f'clifford train: Hamiltonian union of {len(train)} positions',
          lambda: fft.concatenate_without_filter_function(train), card, log)
    stage(f'clifford train: concatenate {len(train)} positions',
          lambda: fft.concatenate(train), card, log)
    X, _, Z = fft.util.paulis[1:]
    n_pulses, n_omega = chip_smoke.TRAIN_SHAPE
    not_pulse = fft.PulseSequence([[X / 2, [np.pi], 'X']],
                                  [[Z / 2, [1], 'Z']], [1], device=device)
    not_pulse.cache_filter_function(np.geomspace(1e-2, 1e2, n_omega))
    pair = [not_pulse, copy.copy(not_pulse)] * (n_pulses // 2)
    stage(f'concat train: general path on {n_pulses} positions of two '
          'objects', lambda: fft.concatenate(pair), card, log)

    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(log.getvalue())
    return 0


if __name__ == '__main__':
    sys.exit(main())
