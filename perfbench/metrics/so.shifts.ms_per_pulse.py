"""``so.shifts.ms_per_pulse``: device time of the operations launched
inside the program's ``ff.so.shifts`` spans
(``numeric._second_order_diag_shifts``: the complete-step product and
the chunks of the separable K2 tables), per pulse of the traced window;
left out where the program has no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.so.shifts'))
