"""``etm.backward.idle_ms_per_pulse``: device idle time of the traced
window inside the program's ``ff.etm.backward`` ranges (the whole
backward of the error transfer matrix, on autograd's thread), every gap
counted, per pulse of the traced window; left out where the program has
no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.idle_under_s(run.trace, 'ff.etm.backward'))
