"""4-qubit quantum Fourier transform on the PyTorch port: the flagship
pulse (d = 16, 13 segments, 18 + 18 operators, 256-element basis) on the
object path at 500 frequencies.  On a CUDA card its control matrix
(K = 13 d^2 = 3328) takes the factored Ozaki route and launches the
``dword_digits`` kernel.

Counterpart of examples/qft.py.
Run: python examples_torch/qft.py [--device cpu] [--plot [--out DIR]]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from filter_functions_tpu_torch import infidelity, util  # noqa: E402
from filter_functions_tpu_torch.models import qft  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--plot', action='store_true')
    parser.add_argument('--n-qubits', type=int, default=4)
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulse (default 'cuda')")
    parser.add_argument('--out', default=None,
                        help='directory of the figure (default: a fresh '
                             'temporary directory)')
    args = parser.parse_args(argv)

    pulse = qft.qft_pulse(args.n_qubits, device=args.device)

    # Verify the propagator implements the QFT (up to bit reversal)
    prop = qft.swap_all(args.n_qubits) @ pulse.total_propagator.cpu().numpy()
    equal, phase = util.oper_equiv(
        prop, qft.qft_propagator(args.n_qubits), eps=1e-10)
    print(f'Correct action: {equal} (global phase {phase:.4f})')

    omega = np.logspace(-2, 2, 500)
    F = pulse.get_filter_function(omega)
    print(f'Fidelity filter function: {tuple(F.shape)} '
          f'({len(pulse.n_opers)} noise operators)')

    infid = infidelity(pulse, 1e-4 / omega, omega)
    print(f'Total infidelity: {infid.sum():.3e}')
    out = {'correct_action': bool(equal), 'global_phase': float(phase),
           'filter_function_shape': tuple(F.shape),
           'infidelity': infid.sum().item()}

    if args.plot:
        try:
            import matplotlib
        except ImportError:
            print('matplotlib missing; skipped the plot')
            return out
        matplotlib.use('Agg')
        from filter_functions_tpu_torch import plotting
        fig, ax, leg = plotting.plot_filter_function(pulse, omega)
        ax.legend(bbox_to_anchor=(1.05, 1), loc=2, borderaxespad=0.)
        path = Path(args.out or tempfile.mkdtemp()) / 'qft_filter_function.png'
        fig.savefig(path, bbox_inches='tight')
        print(f'wrote {path}')
    return out


if __name__ == '__main__':
    main()
