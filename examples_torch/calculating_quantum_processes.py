"""Calculating quantum processes on the PyTorch port: decay amplitudes,
frequency shifts, cumulant function, and the error transfer matrix (the
full quantum process up to second order in noise).

Counterpart of examples/calculating_quantum_processes.py (the
reference's calculating_quantum_processes notebook).

Run: python examples_torch/calculating_quantum_processes.py
     [--device cpu]
"""
import argparse
import sys
from math import pi
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import filter_functions_tpu_torch as fft  # noqa: E402
from filter_functions_tpu_torch import numeric, superoperator, util  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulse (default 'cuda')")
    args = parser.parse_args(argv)

    I, X, Y, Z = util.paulis

    # A simple NOT gate with dephasing and amplitude noise.
    segments = 20
    dt = np.full(segments, 1.0 / segments)
    amp = np.full(segments, pi)
    pulse = fft.PulseSequence(
        [[X / 2, amp, 'X']],
        [[Z / 2, np.ones(segments), 'Z'],
         [X / 2, np.ones(segments), 'X']],
        dt, basis=fft.Basis.pauli(1), device=args.device)

    omega = util.get_sample_frequencies(pulse, n_samples=400)
    S = 1e-4 / omega  # 1/f noise on both channels

    # Decay amplitudes Gamma_{alpha beta, kl}
    gamma = numeric.calculate_decay_amplitudes(pulse, S, omega)
    print(f'decay amplitudes shape {tuple(gamma.shape)}')

    # Second-order Magnus contribution: frequency shifts Delta
    delta = numeric.calculate_frequency_shifts(pulse, S, omega)
    print(f'frequency shifts shape {tuple(delta.shape)}')

    # Cumulant function K and the error transfer matrix exp(K).
    K1 = numeric.calculate_cumulant_function(pulse, S, omega,
                                             second_order=False)
    U1 = fft.error_transfer_matrix(pulse, S, omega)
    U2 = fft.error_transfer_matrix(pulse, S, omega, second_order=True)
    shift = (U2 - U1).abs().max().item()
    print(f'cumulant K shape {tuple(K1.shape)}; '
          f'second-order shift of exp(K): {shift:.3e}')

    # The error transfer matrix is a quantum map: check complete
    # positivity of the full process exp(K) @ Liouville(Q).
    total = U2 @ pulse.total_propagator_liouville.to(U2)
    cp = bool(superoperator.liouville_is_CP(total, pulse.basis))
    print(f'full process completely positive: {cp}')

    # Leading-order infidelity is tr(Gamma_alpha)/d summed over
    # noise operators.
    infid = fft.infidelity(pulse, S, omega).sum().item()
    approx = (gamma.diagonal(dim1=-2, dim2=-1).sum().real / pulse.d).item()
    print(f'infidelity {infid:.3e} vs Gamma-trace identity '
          f'{approx:.3e}')
    return {'decay_amplitudes_shape': tuple(gamma.shape),
            'frequency_shifts_shape': tuple(delta.shape),
            'cumulant_shape': tuple(K1.shape), 'second_order_shift': shift,
            'completely_positive': cp, 'infidelity': infid,
            'gamma_trace': approx}


if __name__ == '__main__':
    main()
