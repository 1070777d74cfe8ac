"""Noise spectroscopy on the PyTorch port: reconstruct S(omega) from
measured infidelities.

The Alvarez-Suter protocol in filter-function language: CPMG trains of
varying period probe the spectrum at their harmonics; collecting the
measured infidelities I_p = 1/(2 pi d) int F_p S turns spectrum
estimation into a linear inverse problem, solved here by non-negative
least squares on the device.

Counterpart of examples/noise_spectroscopy.py.
Run: python examples_torch/noise_spectroscopy.py [--device cpu] [--out DIR]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import filter_functions_tpu_torch as fft  # noqa: E402
from filter_functions_tpu_torch import spectroscopy, util  # noqa: E402

X, Z = util.paulis[1], util.paulis[3]


def cpmg_pulse(n, tau, device='cuda'):
    """n-pulse CPMG train of total duration tau with Z dephasing."""
    delta = np.array([0] + [(g - 0.5) / n for g in range(1, n + 1)])
    tau_pi = 1e-4
    s, t = np.array([]), np.array([0.0])
    for i in range(len(delta) - 1):
        s = np.append(s, np.pi / tau_pi * np.array([0, 1]))
        t = np.append(t, tau_pi * np.array([0, 1])
                      + (delta * tau)[i + 1] - tau_pi / 2)
    t = np.append(t, tau)
    s = np.append(s, 0)
    return fft.PulseSequence([[X / 2, s]],
                             [[Z / 2, np.ones_like(np.diff(t))]],
                             np.diff(t), device=device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulses (default 'cuda')")
    parser.add_argument('--out', default=None,
                        help='directory of the figure (default: a fresh '
                             'temporary directory)')
    args = parser.parse_args(argv)

    # --- the "experiment": a family of CPMG trains -----------------------
    taus = np.geomspace(0.3, 30, 16)
    pulses = [cpmg_pulse(8, tau, args.device) for tau in taus]
    omega = np.geomspace(2e-1, 2e2, 400)
    ffs = torch.stack([p.get_filter_function(omega)[0, 0].real
                       for p in pulses])

    # --- synthetic ground truth and "measured" infidelities --------------
    rng = np.random.default_rng(0)
    s_model = 1e-3 / omega**0.7 + 5e-6 / (1 + (omega - 20)**2)  # 1/f + peak
    measured = np.array([fft.infidelity(p, s_model, omega)[0].item()
                         for p in pulses])
    measured *= 1 + 0.02 * rng.standard_normal(len(measured))  # shot noise

    # --- reconstruction --------------------------------------------------
    a, nodes = spectroscopy.design_matrix(ffs, omega, n_nodes=12)
    s_nodes = spectroscopy.reconstruct(a, measured, ridge=1e-9,
                                       curvature=1e-8)
    s_hat = spectroscopy.interpolate_spectrum(s_nodes, nodes,
                                              omega).cpu().numpy()

    resid = (a @ s_nodes).cpu().numpy() - measured
    print(f'{len(pulses)} pulses, {len(nodes)} spectrum nodes')
    fit = float(np.abs(resid / measured).max())
    print(f'measurement fit residual (rel): {fit:.2e}')
    interior = (omega > nodes[1]) & (omega < nodes[-2])
    recovery = float(np.median(np.abs(s_hat[interior] / s_model[interior]
                                      - 1)))
    print(f'spectrum recovery, interior median rel err: {recovery:.2%}')
    out = {'pulses': len(pulses), 'nodes': len(nodes),
           'fit_residual': fit, 'recovery_median_rel_err': recovery,
           's_nodes': s_nodes.cpu().numpy()}

    try:
        import matplotlib
    except ImportError:
        return out
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    ax.loglog(omega, s_model, label='true S(omega)')
    ax.loglog(omega, s_hat, '--', label='reconstructed')
    ax.loglog(nodes, out['s_nodes'], 'o', ms=4, label='nodes')
    ax.set_xlabel(r'$\omega$')
    ax.set_ylabel(r'$S(\omega)$')
    ax.legend()
    path = Path(args.out or tempfile.mkdtemp()) / 'noise_spectroscopy.png'
    fig.savefig(path, dpi=100)
    plt.close(fig)
    print(f'wrote {path}')
    return out


if __name__ == '__main__':
    main()
