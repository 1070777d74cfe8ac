"""Optimal control on the PyTorch port: shape a pulse to minimize
noise-induced infidelity with the GRAPE loop on the device,
cross-checking the analytic filter-function gradient against autograd.

The gradient formalism is the subject of Le et al., PRApplied 17,
024006 (2022) (reference gradient.py).

Counterpart of examples/optimal_control.py.
Run: python examples_torch/optimal_control.py [--steps 300] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import filter_functions_tpu_torch as fft  # noqa: E402
from filter_functions_tpu_torch import functional, gradient, parallel, util  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--segments', type=int, default=16)
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulse (default 'cuda')")
    args = parser.parse_args(argv)

    I, X, Y, Z = util.paulis
    n_dt = args.segments
    rng = np.random.default_rng(0)
    dt = np.full(n_dt, 1.0 / n_dt)

    # start from a noisy X-rotation attempt
    c0 = np.pi + 0.3 * rng.standard_normal((2, n_dt))
    pulse = fft.PulseSequence(
        [[X / 2, c0[0], 'X'], [Y / 2, c0[1], 'Y']],
        [[Z / 2, np.ones(n_dt), 'Z']], dt,
        basis=fft.Basis.pauli(1), device=args.device)
    omega = util.get_sample_frequencies(pulse, n_samples=200)
    S = 1e-3 / np.asarray(omega)

    # 1. the analytic derivative the reference exposes ...
    dI = gradient.infidelity_derivative(pulse, S, omega)
    # 2. ... equals torch.autograd through the functional pipeline
    p = functional.make_pulse_arrays(pulse)
    S_dev = torch.as_tensor(S, device=p.c_coeffs.device)
    omega_dev = torch.as_tensor(omega, device=p.c_coeffs.device)
    c = p.c_coeffs.clone().requires_grad_(True)
    g, = torch.autograd.grad(functional.infidelity(
        p._replace(c_coeffs=c), S_dev, omega_dev).sum(), c)
    # dI has shape (n_nops, n_dt, n_ctrl); sum noise axis, transpose
    closed = dI.sum(0).T
    rel = ((closed - g).abs().max() / g.abs().max()).item()
    print(f'analytic vs autodiff gradient: rel diff {rel:.2e}')

    # 3. multi-start GRAPE: batch of perturbed candidates
    batch = 8
    cb = torch.as_tensor(c0[None] * (
        1 + 0.2 * rng.standard_normal((batch, 1, 1))),
        device=p.c_coeffs.device)
    res = parallel.optimize_pulse(
        p._replace(c_coeffs=cb), S_dev, omega_dev, n_steps=args.steps,
        learning_rate=2e-2)
    history = res.history.cpu().numpy()
    best = int(torch.argmin(res.infidelity))
    best_infid = res.infidelity[best].item()
    print(f'initial loss {history[0]:.3e} -> final '
          f'{history[-1]:.3e} over {args.steps} steps')
    print(f'best candidate #{best}: infidelity {best_infid:.3e}')

    # the optimized pulse, back in the object API
    c_best = res.c_coeffs[best].detach().cpu().numpy()
    optimized = fft.PulseSequence(
        [[X / 2, c_best[0], 'X'], [Y / 2, c_best[1], 'Y']],
        [[Z / 2, np.ones(n_dt), 'Z']], dt, basis=fft.Basis.pauli(1),
        device=args.device)
    infid0 = fft.infidelity(pulse, S, omega).sum().item()
    infid1 = fft.infidelity(optimized, S, omega).sum().item()
    print(f'infidelity: {infid0:.3e} (initial) -> {infid1:.3e} '
          f'(optimized), {infid0 / infid1:.1f}x lower')
    return {'gradient_rel_diff': rel, 'initial_loss': float(history[0]),
            'final_loss': float(history[-1]), 'best': best,
            'best_infidelity': best_infid, 'infidelity_initial': infid0,
            'infidelity_optimized': infid1, 'improvement': infid0 / infid1}


if __name__ == '__main__':
    main()
