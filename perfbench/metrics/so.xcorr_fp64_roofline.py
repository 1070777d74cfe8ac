"""``so.xcorr_fp64_roofline``: the share of the card's dense FP64
tensor-core peak that the second-order frequency shifts of a
cross-spectrum reach in the traced window: the floating-point
operations that the window's pulses need for them, counted here from
the configuration's shapes and nothing counted by the program, over the
device time of the operations launched inside the program's
``ff.so.shifts`` spans, against 67 TFLOP/s.  Left out where the program
has no such span.

The work is a floor that no exact route goes below, so that the share
cannot pass 100 %: the diagonal spectrum's count of
``so.shifts_fp64_roofline`` (:func:`pulse_flops` there, imported) at
one weighted lattice, r = 1 profile of the spectrum, which a separable
S_ab(w) = C_ab s(w) has; plus the mixing of the n_c correlated noise
operators by C, a complex (n_c x n_c) product over the complete steps'
n_b n_w and the incomplete steps' n_b d^2 entries a segment,
8 n_c^2 n_b (n_w + d^2) G.  Nothing is counted once per pair of
operators.

The shapes are read from the configuration ``qft4_etm2_xcorr``
(``perfbench/configs/qft4_etm2_xcorr.json``), the one configuration
whose cell lists this metric; the count holds for no other.
"""
import json
from pathlib import Path

from perfbench.lib import manifest
from perfbench.metrics import _program

ROOT = Path(__file__).resolve().parents[2]
#: The diagonal spectrum's count and the card's peak.
DIAGONAL = manifest.module(ROOT, 'metrics', 'so.shifts_fp64_roofline')
FP64_PEAK_FLOP_PER_S = DIAGONAL.FP64_PEAK_FLOP_PER_S
#: The configuration whose shapes are counted.
CONFIG = 'qft4_etm2_xcorr'


def configuration(root: Path = ROOT) -> dict:
    """The configuration ``qft4_etm2_xcorr`` as the manifest names its
    file."""
    entry = {c['name']: c for c in manifest.load_manifest(root)['configs']
             }[CONFIG]
    return json.loads((Path(root) / entry['file']).read_text())


def pulse_flops(config: dict) -> int:
    """Floating-point operations of one pulse's frequency shifts under
    the configuration's cross-spectrum."""
    shapes = dict(DIAGONAL.shapes(config), n_spectra=1)
    n_c = len(config['correlations']['operators'])
    mixing = 8 * n_c ** 2 * shapes['n_basis'] * (
        shapes['n_omega'] + shapes['d'] ** 2) * shapes['n_segments']
    return DIAGONAL.pulse_flops(**shapes) + mixing


def read(run):
    if not run.pulses:
        return None
    seconds = _program.launched_under_s(run.trace, 'ff.so.shifts')
    if not seconds:
        return None
    flops = pulse_flops(configuration())
    return 100.0 * run.pulses * flops / seconds / FP64_PEAK_FLOP_PER_S
