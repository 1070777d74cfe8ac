"""Extending pulses on the PyTorch port: map single-qubit pulses onto a
multi-qubit register, reusing cached filter functions, and permute qubit
order.

Counterpart of examples/extending_pulses.py (the reference's
extending_pulses notebook).

Run: python examples_torch/extending_pulses.py [--device cpu]
"""
import argparse
import sys
import time
from math import pi
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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulses (default 'cuda')")
    args = parser.parse_args(argv)

    I, X, Y, Z = util.paulis
    segments = 20
    dt = np.full(segments, 1.0 / segments)

    # Single-qubit primitives with dephasing noise, Pauli basis
    # (extension requires a separable basis).
    not_q = fft.PulseSequence(
        [[X / 2, np.full(segments, pi), 'X']],
        [[Z / 2, np.ones(segments), 'Z']],
        dt, basis=fft.Basis.pauli(1), device=args.device)
    idle = fft.PulseSequence(
        [[X / 2, np.zeros(segments), 'X']],
        [[Z / 2, np.ones(segments), 'Z']],
        dt, basis=fft.Basis.pauli(1), device=args.device)

    omega = util.get_sample_frequencies(not_q, n_samples=200)
    not_q.cache_filter_function(omega)
    idle.cache_filter_function(omega)

    # NOT on qubit 0, idle on qubit 1 -> two-qubit pulse; cached
    # filter functions are scaled + scattered, not recomputed.
    t0 = _clock(args.device)
    two_qubit = fft.extend([(not_q, 0, {'X': 'X_0', 'Z': 'Z_0'}),
                            (idle, 1, {'X': 'X_1', 'Z': 'Z_1'})])
    t_ext = _clock(args.device) - t0
    cached = two_qubit.is_cached('filter function')
    print(f'extend with cache reuse:  {t_ext:7.4f} s (FF cached: {cached})')
    identifiers = two_qubit.n_oper_identifiers.tolist()
    print(f'd = {two_qubit.d}, noise opers: {identifiers}')

    # Validate against the explicitly built register.
    H_c = [[util.tensor(X / 2, I), np.full(segments, pi), 'X_0'],
           [util.tensor(I, X / 2), np.zeros(segments), 'X_1']]
    H_n = [[util.tensor(Z / 2, I), np.ones(segments), 'Z_0'],
           [util.tensor(I, Z / 2), np.ones(segments), 'Z_1']]
    explicit = fft.PulseSequence(H_c, H_n, dt, basis=fft.Basis.pauli(2),
                                 device=args.device)
    f_ext = two_qubit.get_filter_function(omega)
    f_exp = explicit.get_filter_function(omega)
    diff = (f_ext - f_exp).abs().max().item()
    print(f'extended vs explicit max |diff|: {diff:.3e}')

    # Additional entangling noise on the extended register:
    with_zz = fft.extend(
        [(not_q, 0, {'X': 'X_0', 'Z': 'Z_0'}),
         (idle, 1, {'X': 'X_1', 'Z': 'Z_1'})],
        additional_noise_Hamiltonian=[
            [util.tensor(Z, Z) / 4, np.ones(segments), 'ZZ']])
    zz_identifiers = with_zz.n_oper_identifiers.tolist()
    print(f'with ZZ noise: {zz_identifiers}')

    # remap: permute the qubit order; the cached control matrix
    # follows by index permutation of the Pauli basis.  Relabeling
    # qubits leaves each identifier's filter function invariant.
    swapped = fft.remap(two_qubit, (1, 0))
    f_swap = swapped.get_filter_function(omega)
    swap_cached = swapped.is_cached('filter function')
    invariant = torch.allclose(f_swap, f_ext, atol=1e-14)
    print(f'remap keeps FF cached: {swap_cached}; '
          f'per-identifier FFs invariant: {invariant}')
    return {'extend_s': t_ext, 'extend_cached': cached, 'd': two_qubit.d,
            'identifiers': identifiers, 'extended_vs_explicit': diff,
            'zz_identifiers': zz_identifiers, 'remap_cached': swap_cached,
            'remap_invariant': invariant}


if __name__ == '__main__':
    main()
