"""``prep.idle_ms_per_pulse``: device idle time of the traced window
inside the program's ``ff.prep`` spans (``functional._prep``: the
Hamiltonians, ``eigh`` with its own check, the propagators, the step
terms and the degenerate-eigenspace term with its read of the device),
every gap counted, per pulse."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.idle_under_s(run.trace, 'ff.prep'))
