"""``etm.cumulant.backward.idle_ms_per_pulse``: device idle time of the
traced window inside the program's ``ff.etm.cumulant.backward`` ranges
(the backward of the exponential and the cumulant), every gap counted,
per pulse of the traced window; left out where the program has no such
span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.idle_under_s(run.trace, 'ff.etm.cumulant.backward'))
