"""Readings that the limits of a cell's comparison are set from.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] --control-seeds <n> [<n> ...]

In one process, on the card: the cell's set-up once, then for each seed
a short closed-loop window at the cell's own load and the comparison of
a run, which gives the program's numbers; for each control seed the
same window, with the control in the program's place for the compared
sample: the plain reference one precision below the configuration's
(float32 for float64), judged against the reference.  Prints one JSON
line per seed and, last, the largest program reading and the smallest
control reading of each number.  The benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402
from perfbench.lib import check, manifest  # noqa: E402


def readings(cell, root, device, seconds, seeds, control_seeds):
    """({number: [program readings]}, {number: [control readings]})."""
    entry, data, spans = run.set_up(cell, root, device, seeds[0], False)
    reference = manifest.module(root, 'reference',
                                cell.workload['config']).Reference(
        data, device)
    program, control = {}, {}
    for seed, is_control in ([(s, False) for s in seeds]
                             + [(s, True) for s in control_seeds]):
        t0 = time.perf_counter()
        win = run.window(entry, cell, device, seed, seconds, spans)
        picked = check.sample_calls([c.size for c, _ in win.done],
                                    int(cell.mix['check_calls']), seed)
        done = [win.done[i] for i in picked]
        if is_control:
            done = entry.control(done, reference)
        numbers = entry.compare(done, reference)
        out = control if is_control else program
        for name, value in numbers.items():
            out.setdefault(name, []).append(value)
        print(json.dumps({'seed': seed, 'control': is_control,
                          'calls': len(win.done), 'compared': len(done),
                          'numbers': numbers,
                          'seconds': time.perf_counter() - t0}), flush=True)
    return program, control


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seconds', type=float, default=3.0)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
    args = parser.parse_args(argv)
    run.set_environment(ROOT)
    import torch
    if not torch.cuda.is_available():
        print('calibrate: no CUDA card', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    print(f'card: {run.card_line()}', flush=True)
    cell = manifest.cell(ROOT, args.workload)
    program, control = readings(cell, ROOT, device, args.seconds,
                                args.seeds, args.control_seeds)
    print(json.dumps({
        'workload': cell.name,
        'lower': {k: max(v) for k, v in program.items()},
        'upper': {k: min(v) for k, v in control.items()},
        'program': program, 'control': control}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
