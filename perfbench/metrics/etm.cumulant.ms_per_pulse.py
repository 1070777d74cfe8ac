"""``etm.cumulant.ms_per_pulse``: device time of the operations launched
inside the program's ``ff.etm.cumulant`` spans (the cumulant function's
trace contraction and the matrix exponential), per pulse of the traced
window; left out where the program has no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.etm.cumulant'))
