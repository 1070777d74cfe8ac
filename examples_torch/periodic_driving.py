"""Periodic driving on the PyTorch port: the three ways to compute the
filter function of a pulse repeated 10^4 times, from slowest to fastest.

Counterpart of examples/periodic_driving.py (the reference's
periodic_driving notebook).

Run: python examples_torch/periodic_driving.py [--repeats 10000]
     [--brute-force] [--device cpu]
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


def _clock(device) -> float:
    """Host seconds, after the card's queue has drained."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
    return time.perf_counter()


def make_not_pulse(segments: int = 20, device='cuda'):
    """A resonantly driven NOT gate, rotating-frame Hamiltonian."""
    I, X, Y, Z = util.paulis
    amp = np.pi / segments
    H_c = [[X / 2, np.full(segments, amp), 'X']]
    H_n = [[Z / 2, np.ones(segments), 'Z']]
    dt = np.full(segments, 1.0 / segments)
    return fft.PulseSequence(H_c, H_n, dt, device=device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--repeats', type=int, default=10_000)
    parser.add_argument('--brute-force', action='store_true',
                        help='also run the from-scratch computation over '
                             'all repeats*segments segments')
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulse (default 'cuda')")
    args = parser.parse_args(argv)

    atomic = make_not_pulse(device=args.device)
    omega = util.get_sample_frequencies(atomic, n_samples=400,
                                        spacing='log')

    t0 = _clock(args.device)
    atomic.cache_filter_function(omega)
    t_atomic = _clock(args.device) - t0
    print(f'ATOMIC filter function:      {t_atomic:8.4f} s')

    t0 = _clock(args.device)
    periodic = fft.concatenate_periodic(atomic, args.repeats)
    t_periodic = _clock(args.device) - t0
    print(f'PERIODIC (closed form):      {t_periodic:8.4f} s')

    t0 = _clock(args.device)
    standard = fft.concatenate([atomic] * args.repeats)
    t_standard = _clock(args.device) - t0
    print(f'STANDARD concatenate:        {t_standard:8.4f} s')

    f_per = periodic.get_filter_function(omega)
    f_std = standard.get_filter_function(omega)
    diff = (f_per - f_std).abs().max().item()
    print(f'periodic vs standard max |diff|: {diff:.3e}')
    out = {'atomic_s': t_atomic, 'periodic_s': t_periodic,
           'standard_s': t_standard, 'periodic_vs_standard': diff}

    if args.brute_force:
        t0 = _clock(args.device)
        brute = fft.concatenate_without_filter_function(
            [atomic] * args.repeats)
        f_brute = brute.get_filter_function(omega)
        t_brute = _clock(args.device) - t0
        out['brute_force_s'] = t_brute
        out['periodic_vs_brute_force'] = (f_per - f_brute).abs().max().item()
        print(f'BRUTE FORCE from scratch:    {t_brute:8.4f} s   '
              f'(max |diff| {out["periodic_vs_brute_force"]:.3e})')
    return out


if __name__ == '__main__':
    main()
