"""Randomized benchmarking on the PyTorch port: filter-function
infidelities of random Clifford sequences against sequence length, each
Clifford's control matrix computed once and reused for every sequence.

Counterpart of examples/randomized_benchmarking.py.

Run: python examples_torch/randomized_benchmarking.py
     [--lengths 1 5 10] [--samples 10] [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import filter_functions_tpu_torch as fft  # noqa: E402
from filter_functions_tpu_torch import util  # noqa: E402
from filter_functions_tpu_torch.models import rb  # noqa: E402


def _clock(device) -> float:
    """Host seconds, after the card's queue has drained."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--lengths', type=int, nargs='+',
                        default=[1, 2, 5, 10, 20])
    parser.add_argument('--samples', type=int, default=10)
    parser.add_argument('--n-omega', type=int, default=301)
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulses (default 'cuda')")
    args = parser.parse_args(argv)

    rng = np.random.default_rng(2024)
    pulses = rb.clifford_pulses(device=args.device)
    omega = util.get_sample_frequencies(pulses[0], n_samples=args.n_omega)
    t0 = _clock(args.device)
    for p in pulses:
        p.cache_filter_function(omega)
    t_cache = _clock(args.device) - t0
    print(f'cached 24 Clifford control matrices in {t_cache:.2f} s')

    spectrum = 1e-4 / omega  # 1/f dephasing

    out = {'cache_s': t_cache, 'infidelity_mean': {}, 'infidelity_std': {},
           'seq_s': {}}
    print(f'{"m":>4} {"mean infid":>12} {"std":>12} {"time/seq":>10}')
    for m in args.lengths:
        infids = []
        t0 = _clock(args.device)
        for _ in range(args.samples):
            idx, rec = rb.sample_sequence(m, rng)
            seq = rb.rb_pulse(idx, rec, pulses)
            infids.append(fft.infidelity(seq, spectrum, omega).sum().item())
        per_seq = (_clock(args.device) - t0) / args.samples
        print(f'{m:>4} {np.mean(infids):>12.3e} '
              f'{np.std(infids):>12.3e} {per_seq:>9.3f}s')
        out['infidelity_mean'][m] = float(np.mean(infids))
        out['infidelity_std'][m] = float(np.std(infids))
        out['seq_s'][m] = per_seq
    return out


if __name__ == '__main__':
    main()
