"""Where the time of ``extend`` goes on one CUDA card, at the inputs of
chip_smoke.py's phase 10a (two d = 4 parts with filter functions cached
at 1000 frequencies, extended to N = 4 with three crosstalk operators).

For each stage it prints the host time ending in a synchronize (median
of 7, ms), the device time of one run from torch.profiler and the idle
share it implies:

* ``extend`` as a whole, cold (a new register pulse each call);
* ``extend`` without the filter function: the host operators, the
  register's Pauli basis and the Kronecker chain of the cached
  diagonalizations;
* ``Basis.pauli(4)`` alone;
* the three crosstalk rows from scratch on the default route (the
  kernel's K = 3328, J = 3 call) and on the native route;
* ``cache_filter_function`` of the assembled control matrix (total
  phases, the total Liouville propagator in the 256-element basis, the
  filter function);
* beside them, the control matrix of the explicitly built register
  pulse from scratch on the default route, cold.

    python3 scripts/torch_extend_stages.py [PROFILE_TABLES]

With a path, the profiler's tables (12 rows per stage) and the host
profile of one cold ``extend`` (cProfile, 25 rows by cumulative time)
are written there.
"""
import cProfile
import io
import pstats
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from filter_functions_tpu_torch import basis, numeric  # noqa: E402
from torch_concat_stages import stage  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_extend_stages: no CUDA card', file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    card = chip_smoke._card_label()
    log = io.StringIO()
    omega = torch.from_numpy(
        np.geomspace(1e-2, 1e2, chip_smoke.N_OMEGA)).to(device)
    parts, explicit, extra, _ = chip_smoke._extend_parts(device)
    for part in parts:
        part.cache_filter_function(omega)

    def extend(**kw):
        return chip_smoke.fft.extend(
            [(parts[0], (0, 2)), (parts[1], (3, 1))],
            additional_noise_Hamiltonian=extra, **kw)

    stage('extend, cold', extend, card, log)
    stage('extend without the filter function (operators, basis, '
          'Kronecker chain)',
          lambda: extend(cache_filter_function=False,
                         cache_diagonalization=True), card, log)
    stage('Basis.pauli(4)', lambda: basis.Basis.pauli(4), card, log)

    ext = extend()
    rows = chip_smoke._rows(ext, [e[2] for e in extra])
    for route in (None, 'native'):
        stage(f'crosstalk rows from scratch, {route or "default"} route',
              lambda: numeric.calculate_control_matrix_from_scratch(
                  ext.eigvals, ext.eigvecs, ext.propagators, omega,
                  ext.basis, ext.n_opers[rows], ext.n_coeffs[rows], ext.dt,
                  t=ext.t, contract=route), card, log)
    ctrl = ext.get_control_matrix(omega)
    state = {}

    def bare():
        state['pulse'] = extend(cache_filter_function=False,
                                cache_diagonalization=True)
    stage('cache_filter_function of the assembled control matrix',
          lambda: state['pulse'].cache_filter_function(omega, ctrl), card,
          log, setup=bare)

    def scratch():
        explicit.cleanup('all')
        explicit.get_control_matrix(omega)
    stage('explicit register pulse, control matrix from scratch, default '
          'route (cold)', scratch, card, log)

    profile = cProfile.Profile()
    profile.enable()
    extend()
    torch.cuda.synchronize()
    profile.disable()
    out = io.StringIO()
    pstats.Stats(profile, stream=out).sort_stats('cumulative').print_stats(25)
    log.write('== host profile of one cold extend\n' + out.getvalue())
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(log.getvalue())
    return 0


if __name__ == '__main__':
    sys.exit(main())
