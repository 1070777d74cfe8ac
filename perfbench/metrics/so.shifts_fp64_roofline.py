"""``so.shifts_fp64_roofline``: the share of the card's dense FP64
tensor-core peak that the second-order frequency shifts reach in the
traced window: the floating-point operations that the window's pulses
need for them, counted here from the configuration's shapes and nothing
counted by the program, over the device time of the operations launched
inside the program's ``ff.so.shifts`` spans, against 67 TFLOP/s.  Left
out where the program has no such span.

The operations of one pulse (complex products at 8 real operations a
multiply-add, real ones at 2), with G segments, n_nops noise operators,
n_b basis elements, d^2 eigenbasis pairs, n_w frequencies and n_s
distinct rows of the diagonal spectrum:

* the complete steps, sum_{g, w} B*_ak B_al weighted:
  8 n_nops n_b^2 G n_w;
* the separable tables' two real products, each segment's weighted
  lattice sum_w weights[s, w] I[w, ij, mn] from its T = 8 terms, once
  per distinct spectrum row: 2 x 2 d^4 T n_w n_s G.  Operators that
  share one S(w) share one weighted lattice, so work the program spends
  on copies of it is not counted;
* the sandwich of each segment's weighted lattice between the
  noise-basis products: 8 n_nops G (d^4 n_b + n_b^2 d^2).

The shapes are read from the configuration ``qft4_etm2``
(``perfbench/configs/qft4_etm2.json``), the one configuration whose
cell lists this metric; the count holds for no other.
"""
import json
from pathlib import Path

from perfbench.lib import manifest
from perfbench.metrics import _program

#: Dense FP64 tensor-core peak of one NVIDIA H100 SXM (NVIDIA's data
#: sheet, at the 700 W limit), operations/s.
FP64_PEAK_FLOP_PER_S = 6.7e13
#: Terms of the separable tables of the K2 lattice: the general form,
#: the y = 0 limit and six terms of the divided-difference series.
TABLE_TERMS = 8
#: The configuration whose shapes are counted.
CONFIG = 'qft4_etm2'
ROOT = Path(__file__).resolve().parents[2]


def spectrum_rows(config: dict) -> int:
    """Distinct rows of the configuration's diagonal spectrum: one where
    a single S(w) = A / w^p serves every noise operator, one per
    operator where ``amplitude`` lists one for each."""
    amplitude = config['spectrum']['amplitude']
    return len(amplitude) if isinstance(amplitude, list) else 1


def shapes(config: dict) -> dict:
    """The arguments of :func:`pulse_flops` for *config*."""
    return {'d': config['d'], 'n_segments': config['n_segments'],
            'n_nops': config['n_nops'], 'n_basis': config['n_basis'],
            'n_omega': len(manifest.omega(config, ROOT)),
            'n_spectra': spectrum_rows(config)}


def configuration(root: Path = ROOT) -> dict:
    """The configuration ``qft4_etm2`` as the manifest names its file."""
    entry = {c['name']: c for c in manifest.load_manifest(root)['configs']
             }[CONFIG]
    return json.loads((Path(root) / entry['file']).read_text())


def pulse_flops(d: int, n_segments: int, n_nops: int, n_basis: int,
                n_omega: int, n_spectra: int) -> int:
    """Floating-point operations of one pulse's frequency shifts."""
    d2 = d * d
    complete = 8 * n_nops * n_basis ** 2 * n_segments * n_omega
    tables = 2 * 2 * d2 * d2 * TABLE_TERMS * n_omega * n_spectra * n_segments
    sandwich = 8 * n_nops * n_segments * (d2 * d2 * n_basis
                                          + n_basis ** 2 * d2)
    return complete + tables + sandwich


def read(run):
    if not run.pulses:
        return None
    seconds = _program.launched_under_s(run.trace, 'ff.so.shifts')
    if not seconds:
        return None
    flops = pulse_flops(**shapes(configuration()))
    return 100.0 * run.pulses * flops / seconds / FP64_PEAK_FLOP_PER_S
