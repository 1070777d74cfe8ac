"""Stage times of the PyTorch port's error transfer matrix on one CUDA
card: chip_smoke.py's phases 7a (the flagship's first-order ETM through
the object API, one cold call) and 7b (the batched second-order ETM at
bench.py's config_second_order inputs), split into the stages the call
runs, each timed on the host clock with a synchronize after it (median
of 7); 7b's also times the K2 lattice build, which the call no longer
runs, beside the separable tables that replace it.  Also, per workload and for 7c's (ii) and (iii) (the 3-qubit QFT
batch's second-order ETM, the flagship's frequency shifts), the device
time of the whole call from torch.profiler over 3 calls, the idle share
it implies and the share of matrix-product kernels in it; the peak
device memory of one segment's K2 lattice build and of its separable
tables against the counts the chunking uses; and the d = 2 cumulant
function (one matmul with the closed form's combos) against the closed
form written elementwise.

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
#: Substrings of the names of matrix-product kernels.
GEMM_NAMES = ('gemm', 'Gemm', 'GEMM', 'cutlass', 'xmma')


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
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILED
    gemm = sum(e.self_device_time_total for e in kernels
               if any(g in e.key for g in GEMM_NAMES)) / 1e3 / PROFILED
    print(f'{name}: {wall:.4f} ms per call (median of {ROUNDS}); profiler '
          f'device time {device:.4f} ms per call in '
          f'{sum(e.count for e in kernels) / PROFILED:.0f} kernels, idle '
          f'share {1 - device / wall:.3f}, matrix products '
          f'{gemm / device:.3f} of it [{card}]')
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

    def tables(st):
        numeric._second_order_factored_single(omega, st['eigvals'], p.dt)

    def lattice(st):
        numeric._second_order_integral_single(omega, st['eigvals'], p.dt)

    def shifts(st):
        _, n_t, b_t, _, _ = st['terms']
        padded = numeric._pad_cumulative(
            st['step'], st['step'].cumsum(-4)[..., :-1, :, :, :])
        st['delta'] = numeric._second_order_diag_shifts(
            st['eigvals'], n_t, b_t, st['step'], padded, omega, p.dt,
            st['w'][:numeric._distinct_rows(s)]).real

    def trace(st):
        st['k'] = (numeric._cumulant_contract_core(st['gamma'], tg)
                   + numeric._cumulant_contract_core(st['delta'], td))

    def expm(st):
        numeric._expm(st['k'].sum(-3))

    _stages('7b', [('prep', prep), ('per-step contraction', step),
                   ('decay amplitudes', gamma), ('K2 tables alone', tables),
                   ('K2 lattice alone, not on the path', lattice),
                   ('frequency shifts', shifts), ('trace contraction', trace),
                   ('expm', expm)], dict, card)

    state = {}
    prep(state)
    _segment_memory('7b', omega, state['eigvals'], p.dt,
                    numeric._spectral_weights(s, omega, n_nops), len(basis),
                    device, total=True)
    del state
    torch.cuda.reset_peak_memory_stats(device)
    wall = _end_to_end('7b call', lambda: functional.
                       batched_error_transfer_matrix(
                           p, spectrum, omega, basis, second_order=True),
                       lambda: None, card, log)
    print(f'7b: {wall / batch:.4f} ms per evaluation; peak device memory '
          f'{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB')


def _peak_above(fn, device):
    """Peak device bytes of fn() above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return peak


def _segment_memory(name, omega, eigvals, dt, weights, n_basis, device,
                    total=False):
    """Peak memory of one segment (with its leading batch axes) of the
    K2 lattice build (in lattices, against chip_smoke.LATTICE_TEMPS), of
    the separable tables and of the shifts' term built from them (in
    (n_w, d^2) tables, against numeric._SO_FACTORED_TEMPS and the extra
    the shifts count); with *total*, also of the F^(2) term, whose step
    counts four (n_w, A, A) arrays beside the segment's share (9.4 GB
    per pulse at 7c(ii), 340 GB at 7c(iii))."""
    ev, seg_dt = eigvals[..., :1, :], dt[..., :1]
    d2 = ev.shape[-1] ** 2
    n_nops = weights.shape[0]
    batch = ev.shape[:-2].numel()
    unit = batch * len(omega) * d2 * 16             # one (n_w, d^2) table
    lattice = _peak_above(lambda: numeric._second_order_integral_single(
        omega, ev, seg_dt), device)
    tables = _peak_above(lambda: numeric._factored_stacks(omega, ev, seg_dt),
                         device)
    shifts = _peak_above(lambda: numeric._factored_weighted_lattice(
        omega, ev, seg_dt, weights), device)
    line = (f'{name}, one segment x {batch}: K2 lattice build '
            f'{lattice / (unit * d2):.2f} lattices (counted '
            f'{chip_smoke.LATTICE_TEMPS}); separable tables '
            f'{tables / unit:.1f} tables (counted '
            f'{numeric._SO_FACTORED_TEMPS}); shifts term '
            f'{shifts / unit:.1f} (counted '
            f'{numeric._SO_FACTORED_TEMPS + 8 * n_nops})')
    if total:
        nob = torch.zeros(*ev.shape[:-2], 1, n_nops, n_basis, d2,
                          dtype=torch.complex128, device=device)
        f2 = _peak_above(lambda: numeric._second_order_factored_contract(
            omega, ev, seg_dt, nob), device)
        a = n_nops * n_basis
        counted = numeric._SO_FACTORED_TEMPS + (
            d2 + 4 * (2 + numeric._SO_SMALL_K)) * a / d2 + 4 * a * a / d2
        line += (f'; F^(2) term {f2 / unit:.1f} with its (n_w, A, A) '
                 f'output (counted {counted:.1f})')
    print(line)


def second_order_tables(device, card, log):
    """7c(ii) and (iii) as whole calls, and one segment's memory."""
    p, basis, omega, spectrum = chip_smoke.qft3_inputs(device)
    _end_to_end('7c(ii) call', lambda: functional.
                batched_error_transfer_matrix(p, spectrum, omega, basis,
                                              second_order=True),
                lambda: None, card, log)
    eigvals = functional._prep(p, p.c_coeffs, p.n_coeffs, p.dt, omega)[0]
    weights = numeric._spectral_weights(spectrum, omega, p.n_opers.shape[0])
    _segment_memory('7c(ii)', omega, eigvals, p.dt, weights, len(basis),
                    device)
    del p, eigvals

    args = chip_smoke.flagship_shift_inputs(device)
    _end_to_end('7c(iii) call', lambda: numeric._second_order_diag_shifts(
        *args), lambda: None, card, log)
    eigvals, _, b_t, _, _, omega, dt, weights = args
    _segment_memory('7c(iii)', omega, eigvals, dt, weights, b_t.shape[-3],
                    device)


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
    second_order_tables(device, card, log)
    closed_form(device, card)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(log.getvalue())
    return 0


if __name__ == '__main__':
    sys.exit(main())
