"""``contraction.idle_ms_per_pulse``: device idle time of the traced
window inside the program's ``ff.contract`` spans
(``functional._infid_contract``: the Ozaki route's host loops over
slices and levels, ``dword_digits``, the quantization ratio and the
frequency integral), every gap counted, per pulse."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.idle_under_s(run.trace, 'ff.contract'))
