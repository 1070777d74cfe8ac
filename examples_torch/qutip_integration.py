"""QuTiP integration on the PyTorch port: Qobj operators at the package
boundary.

The boundary is duck-typed (util.parse_operators: anything with
``.full()`` / ``.to_array()`` / ``.todense()`` is accepted), so Qobj,
scipy sparse matrices and plain ndarrays can be mixed freely.  qutip
itself is not required: without it this example uses the minimal stub
of ``tests/_qutip_stub.py``, whose ``Qobj`` exposes the same ``.full()``
interface.  The setting is the reference notebook's (a two-qubit IQ toy
model with local X/Y drives and a ZZ exchange coupling) with a smooth
pulse in place of qutip's GRAPE output.

Counterpart of examples/qutip_integration.py.
Run: python examples_torch/qutip_integration.py [--device cpu] [--out DIR]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import filter_functions_tpu_torch as fft  # noqa: E402

try:
    import qutip as qt
except ImportError:
    sys.path.insert(0, str(ROOT / 'tests'))
    import _qutip_stub as qt  # the tests' minimal stand-in


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help="torch device of the pulse (default 'cuda')")
    parser.add_argument('--out', default=None,
                        help='directory of the figure (default: a fresh '
                             'temporary directory)')
    args = parser.parse_args(argv)

    # Two-qubit operators built as tensor products, wrapped in Qobj to
    # exercise the duck-typed boundary.
    I2, X, Y, Z = [np.asarray(p) for p in fft.util.paulis]
    H_c_qobj = [qt.Qobj(np.kron(X, I2)),      # XI
                qt.Qobj(np.kron(Y, I2)),      # YI
                qt.Qobj(np.kron(I2, X)),      # IX
                qt.Qobj(np.kron(I2, Y)),      # IY
                qt.Qobj(np.kron(Z, Z))]       # ZZ exchange
    identifiers = ['XI', 'YI', 'IX', 'IY', 'ZZ']

    # A smooth 50-segment amplitude profile standing in for the GRAPE
    # optimizer's final_amps.
    n_ts, evo_time = 50, 1.0
    t = np.linspace(0, evo_time, n_ts, endpoint=False)
    rng = np.random.default_rng(42)
    amps = np.stack([np.sin(2 * np.pi * (k + 1) * t / evo_time + phi)
                     for k, phi in enumerate(rng.uniform(0, 2 * np.pi, 5))])

    pulse = fft.PulseSequence(
        list(zip(H_c_qobj, amps, identifiers)),
        list(zip(H_c_qobj, np.ones((5, n_ts)), identifiers)),
        [evo_time / n_ts] * n_ts, device=args.device)
    print(f'PulseSequence from Qobj operators: d = {pulse.d}, '
          f'{len(pulse)} segments')

    omega = fft.util.get_sample_frequencies(pulse, spacing='log',
                                            n_samples=200)
    F = pulse.get_filter_function(omega).real.cpu().numpy()
    print('fidelity filter function diag at lowest frequency:')
    f_low = F[np.arange(5), np.arange(5), 0]
    for ident, f0 in zip(pulse.n_oper_identifiers, f_low):
        print(f'  F_{ident}(w_min) = {f0:.4g}')

    infid = fft.infidelity(pulse, 1e-3 / omega, omega).cpu().numpy()
    print('1/f infidelities per noise channel:', np.round(infid, 8))
    out = {'d': pulse.d, 'segments': len(pulse),
           'filter_function_at_w_min': f_low, 'infidelities': infid}

    try:
        import matplotlib
    except ImportError:
        print('matplotlib missing; skipped the plot')
        return out
    matplotlib.use('Agg')
    from filter_functions_tpu_torch import plotting
    fig, axes, _ = plotting.plot_filter_function(pulse, omega)
    path = Path(args.out or tempfile.mkdtemp()) / 'qutip_integration_ff.png'
    fig.savefig(path)
    print('saved', path)
    return out


if __name__ == '__main__':
    main()
