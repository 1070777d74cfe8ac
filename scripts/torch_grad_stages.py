"""Where the time of the gradient goes on one CUDA card: autograd of the
flagship's batched infidelity (chip_smoke.py's phase 8a inputs, one
chunk of 2 pulses at 1000 frequencies) on both contraction routes.

For each route it prints the forward pass and the backward pass on the
host clock, each ending in a synchronize (median of 7, ms per pulse),
the device time of one forward plus backward from torch.profiler and
the idle share it implies, the peak device memory, and the device time
of the backward of each autograd node (the profiler's
``autograd::engine::evaluate_function`` rows: the factored Ozaki
product's, the matmul's, the degenerate-eigenspace term's, the
eigendecomposition's, ...).

    python3 scripts/torch_grad_stages.py [PROFILE_TABLES]

With a path, the profiler's tables (20 rows per route) are written
there.
"""
import io
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from filter_functions_tpu_torch import functional  # noqa: E402

ROUNDS = 7
#: Backward nodes printed per route, by device time.
TOP = 8


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def route(name, p, omega, spectrum, card, log):
    """Forward and backward times, profiler breakdown and peak memory of
    autograd through batched_infidelity on route *name*."""
    batch = p.c_coeffs.shape[0]

    def forward():
        c = p.c_coeffs.detach().clone().requires_grad_(True)
        infid = functional.batched_infidelity(
            p._replace(c_coeffs=c), spectrum, omega, contract=name)
        return c, infid

    fw, bw = [], []
    torch.cuda.reset_peak_memory_stats(omega.device)
    for r in range(ROUNDS + 1):
        (c, infid), ms_f = _sync_time(forward)
        _, ms_b = _sync_time(lambda: torch.autograd.grad(infid.sum(), c))
        if r:
            fw.append(ms_f / batch)
            bw.append(ms_b / batch)
    peak = torch.cuda.max_memory_allocated(omega.device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        c, infid = forward()
        torch.autograd.grad(infid.sum(), c)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # kernel rows only: an op's row repeats its kernels' device time
    device = sum(e.self_device_time_total for e in averages
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 ) / 1e3 / batch
    wall = statistics.median(fw) + statistics.median(bw)
    print(f'{name}: forward {statistics.median(fw):.4f}, backward '
          f'{statistics.median(bw):.4f} ms/pulse (median of {ROUNDS}, '
          f'chunk of {batch}); profiler device time {device:.4f} ms/pulse, '
          f'idle share {1 - device / wall:.3f}; peak device memory '
          f'{peak / 2**30:.2f} GiB [{card}]')
    prefix = 'autograd::engine::evaluate_function: '
    nodes = sorted(((e.key[len(prefix):], e.device_time_total / 1e3 / batch)
                    for e in averages if e.key.startswith(prefix)),
                   key=lambda kv: -kv[1])
    print(f'{name} backward nodes (device ms/pulse): ' + ' | '.join(
        f'{k} {v:.4f}' for k, v in nodes[:TOP]))
    log.write(f'== {name}\n' + averages.table(
        sort_by='self_device_time_total', row_limit=20) + '\n')


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_grad_stages: no CUDA card', file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    card = chip_smoke._card_label()
    batched, omega, spectrum = chip_smoke.flagship_inputs(device)
    p = batched._replace(c_coeffs=batched.c_coeffs[:chip_smoke.CHUNK],
                         n_coeffs=batched.n_coeffs[:chip_smoke.CHUNK],
                         dt=batched.dt[:chip_smoke.CHUNK])
    log = io.StringIO()
    for name in ('ozaki', 'native'):
        route(name, p, omega, spectrum, card, log)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(log.getvalue())
    return 0


if __name__ == '__main__':
    sys.exit(main())
