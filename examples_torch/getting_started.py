"""Getting started: build a Hadamard gate from primitive pulses,
compute its dephasing filter function, and evaluate infidelities for
white and 1/f noise, on the PyTorch port.

Counterpart of examples/getting_started.py (the reference's
getting_started notebook).

Run: python examples_torch/getting_started.py [--device cpu]
"""
import argparse
import sys
from math import pi
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import filter_functions_tpu_torch as fft  # noqa: E402
from filter_functions_tpu_torch import util  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulse (default 'cuda')")
    args = parser.parse_args(argv)

    I, X, Y, Z = util.paulis

    # A Hadamard as a pi/2 y-rotation followed by a pi x-rotation,
    # with constant coupling to dephasing (sigma_z) noise.
    H_c = [[X / 2, [0, pi], 'X'],
           [Y / 2, [pi / 2, 0], 'Y']]
    H_n = [[Z / 2, [1, 1], 'Z']]
    dt = [1, 1]
    hadamard = fft.PulseSequence(H_c, H_n, dt, device=args.device)
    print(hadamard)

    # The total propagator should be a Hadamard up to global phase.
    H_gate = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    equal, phase = util.oper_equiv(hadamard.total_propagator, H_gate)
    print(f'Total propagator is Hadamard: {equal} '
          f'(global phase {phase:+.3f})')

    # Fidelity filter function on the default frequency grid.
    omega = util.get_sample_frequencies(hadamard, n_samples=400)
    F = hadamard.get_filter_function(omega).real
    print(f'F(omega) shape {tuple(F.shape)}; '
          f'DC limit F(omega->0) = {F[0, 0, 0]:.4f}')
    out = {'hadamard': bool(equal), 'global_phase': float(phase),
           'dc_limit': F[0, 0, 0].item()}

    # Infidelities for white and 1/f spectra.
    for name, S in [('white', 1e-4 * np.ones_like(omega)),
                    ('1/f  ', 1e-4 / omega)]:
        infid = fft.infidelity(hadamard, S, omega).sum().item()
        print(f'infidelity ({name}): {infid:.3e}')
        out[f'infidelity_{name.strip()}'] = infid

    # Convergence of the frequency integral.
    n_samples, infids = fft.infidelity(
        hadamard, lambda w: 1e-4 / w,
        {'n_min': 100, 'n_max': 1000, 'n_points': 5},
        test_convergence=True)
    infids = infids.cpu().numpy().ravel()
    print('convergence:', dict(zip(np.asarray(n_samples).tolist(),
                                   infids.round(9))))
    out['convergence'] = dict(zip(np.asarray(n_samples).tolist(),
                                  infids.tolist()))
    return out


if __name__ == '__main__':
    main()
