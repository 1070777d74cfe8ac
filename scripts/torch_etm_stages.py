"""Stage times of the PyTorch port's error transfer matrix on one CUDA
card: chip_smoke.py's phases 7a (the flagship's first-order ETM through
the object API, one cold call) and 7b (the batched second-order ETM at
bench.py's config_second_order inputs), split into the stages the call
runs, each timed on the host clock with a synchronize after it (median
of 7).  Also, per workload, the device time of the whole call from
torch.profiler over 3 calls and the idle share it implies, the peak
device memory of 7b's K2 lattice build against the lattice's size, and
the d = 2 cumulant function (one matmul with the closed form's combos)
against the closed form written elementwise.

    python3 scripts/torch_etm_stages.py [PROFILE_TABLES]

With a path, the profiler's tables (15 rows per workload) are written
there.
"""
import io
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import filter_functions_tpu_torch as fft  # noqa: E402
from filter_functions_tpu_torch import functional, numeric, util  # noqa: E402
from filter_functions_tpu_torch.models import qft  # noqa: E402

ROUNDS = 7
PROFILED = 3


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _stages(name, stage_fns, setup, card):
    """Runs setup() then the stages in order, ROUNDS times after a
    warm-up round, and prints each stage's median ms."""
    times = {}
    for r in range(ROUNDS + 1):
        state = setup()
        for label, fn in stage_fns:
            _, ms = _sync_time(lambda: fn(state))
            if r:
                times.setdefault(label, []).append(ms)
    print(f'{name} stages (ms, median of {ROUNDS}) [{card}]: ' + ' | '.join(
        f'{k} {statistics.median(v):.3f}' for k, v in times.items()))


def _end_to_end(name, fn, setup, card, log):
    """Median wall ms of fn() after setup(), and the device time of
    PROFILED calls from torch.profiler; prints the idle share."""
    walls = []
    for _ in range(ROUNDS + 1):
        setup()
        walls.append(_sync_time(fn)[1])
    wall = statistics.median(walls[1:])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED):
            setup()
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # kernel rows only: an op's row repeats its kernels' device time
    device = sum(e.self_device_time_total for e in averages
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 ) / 1e3 / PROFILED
    print(f'{name}: {wall:.4f} ms per call (median of {ROUNDS}); profiler '
          f'device time {device:.4f} ms per call, idle share '
          f'{1 - device / wall:.3f} [{card}]')
    log.write(f'== {name}\n' + averages.table(
        sort_by='self_device_time_total', row_limit=15) + '\n')
    return wall


def flagship(device, card, log):
    omega = torch.from_numpy(np.geomspace(1e-2, 1e2, chip_smoke.N_OMEGA)
                             ).to(device)
    spectrum = 1e-4 / omega
    pulse = qft.qft_pulse_sequence(4, device=device)

    def setup():
        pulse.cleanup('all')
        return {}

    def k0(st):
        pulse.omega = omega
        pulse.diagonalize()

    def ctrl(st):
        st['ctrl'] = numeric.calculate_control_matrix_from_scratch(
            pulse.eigvals, pulse.eigvecs, pulse.propagators, pulse.omega,
            pulse.basis, pulse.n_opers_dev, pulse.n_coeffs, pulse.dt,
            t=pulse.t)

    def by_products(st):
        pulse.cache_control_matrix(pulse.omega, st['ctrl'])

    def gamma(st):
        st['gamma'] = numeric.calculate_decay_amplitudes(pulse, spectrum,
                                                         omega)

    def cumulant(st):
        st['k'] = numeric.calculate_cumulant_function(
            pulse, decay_amplitudes=st['gamma'])

    def expm(st):
        numeric.error_transfer_matrix(cumulant_function=st['k'])

    _stages('7a', [('omega and K0', k0), ('control matrix', ctrl),
                   ('by-products', by_products), ('decay amplitudes', gamma),
                   ('cumulant', cumulant), ('expm', expm)], setup, card)
    _end_to_end('7a cold call', lambda: fft.error_transfer_matrix(
        pulse, spectrum, omega), setup, card, log)


def second_order(device, card, log):
    p, _, basis, omega, spectrum = chip_smoke.second_order_inputs(device)
    batch = p.c_coeffs.shape[0]
    n_nops = p.n_opers.shape[0]
    s = util.parse_spectrum(spectrum, omega, np.arange(n_nops),
                            device=device)
    tg, td = numeric._cumulant_trace_combos_dev(basis, device)

    def prep(st):
        st['eigvals'], st['terms'], _ = functional._prep(
            p, p.c_coeffs, p.n_coeffs, p.dt, omega)

    def step(st):
        _, n_t, b_t, ph, integral = st['terms']
        st['step'] = numeric._ctrlmat_step_contract(n_t, integral, b_t, ph)

    def gamma(st):
        st['w'] = numeric._spectral_weights(s, omega, n_nops)
        st['gamma'] = numeric._folded_decay_amplitudes(st['step'].sum(-4),
                                                       st['w'])

    def lattice(st):
        numeric._second_order_integral_single(omega, st['eigvals'], p.dt)

    def shifts(st):
        _, n_t, b_t, _, _ = st['terms']
        padded = numeric._pad_cumulative(
            st['step'], st['step'].cumsum(-4)[..., :-1, :, :, :])
        st['delta'] = numeric._second_order_diag_shifts(
            st['eigvals'], n_t, b_t, st['step'], padded, omega, p.dt,
            st['w']).real

    def trace(st):
        st['k'] = (numeric._cumulant_contract_core(st['gamma'], tg)
                   + numeric._cumulant_contract_core(st['delta'], td))

    def expm(st):
        numeric._expm(st['k'].sum(-3))

    _stages('7b', [('prep', prep), ('per-step contraction', step),
                   ('decay amplitudes', gamma), ('K2 lattice alone', lattice),
                   ('frequency shifts', shifts), ('trace contraction', trace),
                   ('expm', expm)], dict, card)

    state = {}
    prep(state)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = numeric._second_order_integral_single(omega, state['eigvals'], p.dt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    size = out.numel() * out.element_size()
    print(f'7b K2 lattice build: lattice {size / 2**30:.3f} GiB, peak above '
          f'its inputs {peak / 2**30:.3f} GiB = {peak / size:.2f} lattices '
          f'(numeric._SO_LATTICE_TEMPS = {numeric._SO_LATTICE_TEMPS})')
    del out, state
    torch.cuda.reset_peak_memory_stats(device)
    wall = _end_to_end('7b call', lambda: functional.
                       batched_error_transfer_matrix(
                           p, spectrum, omega, basis, second_order=True),
                       lambda: None, card, log)
    print(f'7b: {wall / batch:.4f} ms per evaluation; peak device memory '
          f'{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB')


def _closed_form_elementwise(gamma, delta):
    """The single-qubit cumulant function written elementwise, as the
    JAX package computes it: K_ij = Gamma_ij off the diagonal (i, j > 0),
    K_ii = -sum_{k != i, k > 0} Gamma_kk, plus Delta_ji - Delta_ij."""
    off = torch.ones(4, 4, dtype=torch.bool, device=gamma.device)
    off[0] = off[:, 0] = False
    off.fill_diagonal_(False)
    k_fn = torch.where(off, gamma, 0.0)
    diag = torch.diagonal(gamma[..., 1:, 1:], dim1=-2, dim2=-1)
    k_fn[..., 1:, 1:] += torch.diag_embed(diag - diag.sum(-1, keepdim=True))
    k_fn[..., 1:, 1:] += delta[..., 1:, 1:].mT - delta[..., 1:, 1:]
    return k_fn


def closed_form(device, card):
    """The d = 2 cumulant function, both orders, as the port computes it
    (one matmul each with the closed form's combos) against the
    elementwise closed form, on one pulse's (3, 4, 4) and a batch's
    (64, 3, 4, 4) amplitudes."""
    basis = fft.Basis.pauli(1)
    tg, td = numeric._cumulant_trace_combos_dev(basis, device)
    rng = np.random.default_rng(2)
    for lead in ((3,), (64, 3)):
        gamma, delta = (torch.from_numpy(1e-3 * rng.normal(
            size=lead + (4, 4))).to(device) for _ in range(2))

        def elementwise():
            return _closed_form_elementwise(gamma, delta)

        def combos():
            return (numeric._cumulant_contract_core(gamma, tg)
                    + numeric._cumulant_contract_core(delta, td))
        diff = (elementwise() - combos()).abs().max().item()
        walls = {}
        for name, fn in (('elementwise', elementwise), ('combos', combos)):
            runs = [_sync_time(fn)[1] for _ in range(50)]
            walls[name] = (statistics.median(runs[1:]),
                           chip_smoke._cuda_ms(fn, 100))
        print(f'd = 2 cumulant {lead + (4, 4)}: elementwise closed form '
              '{:.4f} ms wall / {:.4f} ms events, combos matmul {:.4f} / '
              '{:.4f} ms; max |diff| {:.3e} [{}]'.format(
                  *walls['elementwise'], *walls['combos'], diff, card))


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_etm_stages: no CUDA card', file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    card = chip_smoke._card_label()
    log = io.StringIO()
    flagship(device, card, log)
    second_order(device, card, log)
    closed_form(device, card)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(log.getvalue())
    return 0


if __name__ == '__main__':
    sys.exit(main())
