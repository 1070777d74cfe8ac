"""Runs one cell of the benchmark of ``filter_functions_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The run
loads the cell's configuration, traffic mix, entry and reference by the
names in ``BENCHMARK.json``, warms up every shape of the cell's traffic,
drives the entry in a closed loop (one caller, each call ending in
``torch.cuda.synchronize()``) for ``--seconds``, and then compares a
sample of the window's answers, drawn from the seed, with the plain
reference.  Its last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``, each compared
number beside its limit; the same numbers are the last lines on
standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
the profiler's trace of the window.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits with 2; if the program loaded JAX or the JAX
package, with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, NamedTuple, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import check, manifest, stats, trace, traffic  # noqa: E402

#: Top-level module names that may not be loaded when the window closes:
#: JAX, and the JAX package of which the measured program is the port.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'filter_functions_tpu')
#: Cache directories of the toolchains, fixed inside the checkout.
CACHE_DIRS = {'TRITON_CACHE_DIR': 'perfbench/.cache/triton',
              'TORCH_EXTENSIONS_DIR': 'perfbench/.cache/torch_extensions'}
THREAD_VARS = ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS')
GIB = 2 ** 30
#: Longest traced window: reading the profiler's events of a window takes
#: a few times the window, and a traced run has to end within 360 s.
TRACE_SECONDS = 25.0


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seconds <= 0:
        parser.error('--seconds must be positive')
    return args


def set_environment(root: Path) -> None:
    """The toolchains' caches inside the checkout, and one host thread
    for the math libraries (one caller, few threads: steadier runs)."""
    for var, rel in CACHE_DIRS.items():
        path = Path(root) / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    for var in THREAD_VARS:
        os.environ[var] = '1'
    os.environ['USE_FLAX'] = '0'


def forbidden_modules() -> List[str]:
    return sorted(name for name in sys.modules
                  if name.split('.')[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f'nvidia-smi unavailable ({err})'


class Window(NamedTuple):
    done: list              # [(traffic.Call, outputs)]
    call_ms: List[float]
    seconds: float
    pulses: int
    peak_bytes: int
    trace: Optional[trace.Trace]


class State:
    """What the per-layer readers see: the trace, the pulses of the traced
    window, the host durations of the spans, and counters."""

    def __init__(self, spans: trace.Spans):
        self.spans = spans
        self.trace = None
        self.pulses = 0
        self.counters = {}


def sync(device) -> None:
    if device.type == 'cuda':
        import torch
        torch.cuda.synchronize(device)


def set_up(cell: manifest.Cell, root: Path, device, seed: int,
           traced: bool):
    """The program's entry with every shape of the cell's traffic warmed
    up, the inputs of both sides, and the spans."""
    spans = trace.Spans(enabled=traced)
    data = manifest.inputs(cell.config, root)
    entry = manifest.module(root, 'entries', cell.mix['entry']).Entry(
        data, cell.mix, device, spans)
    warm = traffic.distinct_calls(cell.mix, cell.config, seed)
    for call in warm:
        entry.call(call)
    if traced:
        entry.prepare_trace(warm[0])
    sync(device)
    return entry, data, spans


def window(entry, cell: manifest.Cell, device, seed: int, seconds: float,
           spans: trace.Spans) -> Window:
    """The closed loop for *seconds*; where the spans are on, under the
    profiler and for at most :data:`TRACE_SECONDS`."""
    import torch
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    profiler = (trace.profile(cuda) if spans.enabled
                else contextlib.nullcontext())
    if spans.enabled:
        seconds = min(seconds, TRACE_SECONDS)
    calls = traffic.calls(cell.mix, cell.config, seed)
    done, call_ms, pulses = [], [], 0
    with profiler:
        t0 = time.perf_counter()
        while True:
            call = next(calls)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            h0 = time.perf_counter()
            with spans('call'):
                outputs = entry.call(call)
                if cuda:
                    stop.record()
                sync(device)
            call_ms.append(start.elapsed_time(stop) if cuda
                           else 1e3 * (time.perf_counter() - h0))
            done.append((call, outputs))
            pulses += entry.pulses(call)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = None
    if spans.enabled:
        t_read = time.perf_counter()
        traced = trace.Trace.from_kineto(trace.events_of(profiler),
                                         set(spans.host_s))
        print(f'trace of {len(done)} calls read in '
              f'{time.perf_counter() - t_read:.1f} s', file=sys.stderr)
    return Window(done, call_ms, elapsed, pulses, peak, traced)


def failed_calls(entry, done) -> int:
    """Calls whose answers have the wrong shape or are not finite."""
    return sum(check.nonfinite(outputs[0], entry.shape(call))
               or any(not bool(o.isfinite().all()) for o in outputs[1:])
               for call, outputs in done)


def judge(entry, reference, done, cell: manifest.Cell, seed: int) -> dict:
    """The compared numbers of a sample of the window's calls."""
    picked = check.sample_calls([c.size for c, _ in done],
                                int(cell.mix['check_calls']), seed)
    return entry.compare([done[i] for i in picked], reference)


def verdict(numbers: dict, limits: dict, failed: int):
    checks = {'failed_calls': {'value': failed, 'limit': 0}}
    for name in numbers:
        checks[name] = {'value': numbers[name], 'limit': limits[name]}
    correct = all(manifest.finite(c['value']) and c['value'] <= c['limit']
                  for c in checks.values())
    return correct, checks


def end_to_end(cell: manifest.Cell, win: Window, setup_s: float) -> dict:
    values = {'pulses_per_s': stats.rate(win.pulses, win.seconds),
              'call_ms_p95': stats.percentile(win.call_ms, 95),
              'peak_mem_gib': win.peak_bytes / GIB,
              'setup_s': setup_s}
    return {m['name']: {'value': values[m['name']], 'unit': m['unit']}
            for m in cell.end_to_end}


def per_layer(readers, state: State) -> dict:
    out = {}
    for metric, mod in readers:
        value = mod.read(state)
        if value is not None:
            out[metric['name']] = {'value': value, 'unit': metric['unit']}
    return out


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """One run.  *device* None looks for the card, as the benchmark does;
    a test passes a device to drive the rest of a run without one."""
    args = parse(argv)
    root = Path(root)
    cell = manifest.cell(root, args.workload)
    set_environment(root)
    import torch
    if device is None:
        need = int(cell.workload['chips'])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < need:
            print(f'perfbench: cell {cell.name} needs {need} CUDA card(s); '
                  f'torch.cuda.is_available() is '
                  f'{torch.cuda.is_available()}, device_count() is '
                  f'{torch.cuda.device_count()}', file=sys.stderr)
            return 2
        device = torch.device('cuda', 0)
        kind = torch.cuda.get_device_name(device)
        print(f'card: {card_line()}; torch {torch.__version__}, CUDA '
              f'{torch.version.cuda}', flush=True)
    else:
        device = torch.device(device)
        kind = str(device)

    entry, data, spans = set_up(cell, root, device, args.seed,
                                bool(args.trace))
    setup_s = time.perf_counter() - T_START
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == 'cuda' else 0)

    state = State(spans)
    readers = []
    if args.trace:
        readers = [(m, manifest.module(root, 'metrics', m['name']))
                   for m in cell.per_layer]
    undo = [mod.instrument(state) for _, mod in readers
            if hasattr(mod, 'instrument')]
    try:
        win = window(entry, cell, device, args.seed, args.seconds, spans)
    finally:
        for fn in undo:
            fn()
    failed = failed_calls(entry, win.done)
    memory_peak = max(setup_peak, win.peak_bytes)

    # the program's state goes before the reference runs on the card
    entry.release()
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = manifest.module(root, 'reference',
                                cell.workload['config']).Reference(
        data, device)
    numbers = judge(entry, reference, win.done, cell, args.seed)
    ref_s = time.perf_counter() - t_ref
    correct, checks = verdict(numbers, cell.limits['numbers'], failed)

    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': kind, 'count': 1, 'memory_peak_bytes': memory_peak}
    result = {'correct': correct, 'attempted': len(win.done),
              'failed': failed}
    if args.trace:
        state.trace, state.pulses = win.trace, win.pulses
        result['metrics'] = per_layer(readers, state)
        if win.trace is not None and win.trace.window is not None:
            dev['busy_s'] = win.trace.busy_s()
            dev['window_s'] = win.trace.window_s()
            result['breakdown'] = {
                'device_ops': win.trace.top_device_ops(),
                'idle_gaps': win.trace.idle_gaps()}
    else:
        result['metrics'] = end_to_end(cell, win, setup_s)
    result['device'] = dev
    result['checks'] = checks

    found = forbidden_modules()
    if found:
        print(f'perfbench: modules of JAX or the JAX package are loaded: '
              f'{found}', file=sys.stderr)
        return 3
    print(f'window {win.seconds:.3f} s, {len(win.done)} calls, '
          f'{win.pulses} pulses; call ms median '
          f'{stats.percentile(win.call_ms, 50):.4f}; reference '
          f'{ref_s:.2f} s on {len(numbers)} number(s); run '
          f'{time.perf_counter() - T_START:.1f} s', file=sys.stderr)
    for name, c in checks.items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
