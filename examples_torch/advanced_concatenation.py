"""Advanced concatenation on the PyTorch port: spin echo from primitive
pulses, cache reuse, and pulse-correlation filter functions.

Counterpart of examples/advanced_concatenation.py (the reference's
advanced_concatenation notebook).

Run: python examples_torch/advanced_concatenation.py [--device cpu]
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


def make_pulses(tau: float = 10.0, segments: int = 50, device='cuda'):
    """free evolution, and a primitive pi_x pulse of the same length."""
    I, X, Y, Z = util.paulis
    dt = np.full(segments, tau / segments)
    wait = fft.PulseSequence([[X / 2, np.zeros(segments), 'X']],
                             [[Z / 2, np.ones(segments), 'Z']], dt,
                             device=device)
    pi_x = fft.PulseSequence([[X / 2, np.full(segments, pi / tau), 'X']],
                             [[Z / 2, np.ones(segments), 'Z']], dt,
                             device=device)
    return wait, pi_x


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulses (default 'cuda')")
    args = parser.parse_args(argv)

    wait, pi_x = make_pulses(device=args.device)
    omega = util.get_sample_frequencies(wait, n_samples=400)

    # Cache the atomic filter functions once ...
    t0 = _clock(args.device)
    wait.cache_filter_function(omega)
    pi_x.cache_filter_function(omega)
    t_atomic = _clock(args.device) - t0
    print(f'atomic FFs:          {t_atomic:7.4f} s')

    # ... then every composite pulse reuses them.
    t0 = _clock(args.device)
    echo = wait @ pi_x @ wait
    t_echo = _clock(args.device) - t0
    cached = echo.is_cached('filter function')
    print(f'echo = w @ pi @ w:   {t_echo:7.4f} s (cached: {cached})')

    # The cached result equals the from-scratch one.
    scratch = fft.concatenate_without_filter_function([wait, pi_x, wait])
    f_cached = echo.get_filter_function(omega)
    f_scratch = scratch.get_filter_function(omega)
    diff = (f_cached - f_scratch).abs().max().item()
    print(f'cached vs scratch max |diff|: {diff:.3e}')

    # Pulse-correlation filter functions F^(gg') resolve which
    # *interference terms* between the constituent pulses contribute.
    echo_pc = fft.concatenate([wait, pi_x, wait],
                              calc_pulse_correlation_FF=True, omega=omega)
    f_pc = echo_pc.get_pulse_correlation_filter_function()
    print(f'F^(gg\') shape: {tuple(f_pc.shape)}')
    total = f_pc.sum((0, 1)).real
    sums = torch.allclose(total, f_cached.real, atol=1e-12)
    print(f'sum over g,g\' equals total FF: {sums}')

    # Infidelity attribution per pulse pair for 1/f noise:
    S = 1e-4 / omega
    infid_pc = fft.infidelity(echo_pc, S, omega, which='correlations')
    infid_pc = infid_pc.cpu().numpy().squeeze()
    print('per-(g,g\') infidelity contributions:')
    print(infid_pc.round(9))
    print(f'total = {infid_pc.sum():.3e}')
    return {'atomic_s': t_atomic, 'echo_s': t_echo, 'echo_cached': cached,
            'cached_vs_scratch': diff,
            'correlation_shape': tuple(f_pc.shape),
            'correlations_sum_to_total': sums,
            'correlation_infidelities': infid_pc,
            'total_infidelity': float(infid_pc.sum())}


if __name__ == '__main__':
    main()
