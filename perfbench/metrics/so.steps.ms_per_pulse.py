"""``so.steps.ms_per_pulse``: device time of the operations launched
inside the program's ``ff.so.steps`` spans (the second-order shifts'
complete steps: the running ``addcmul`` and the ``baddbmm`` a segment
and batch row), per pulse of the traced window; left out where the
program has no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.so.steps'))
