"""``so.sandwich.ms_per_pulse``: device time of the operations launched
inside the program's ``ff.so.sandwich`` spans (the second-order shifts'
noise-basis products, and each chunk's copy of them, incomplete steps'
products and add into the shifts), per pulse of the traced window; left
out where the program has no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.so.sandwich'))
