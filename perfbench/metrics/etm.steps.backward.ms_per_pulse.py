"""``etm.steps.backward.ms_per_pulse``: device time of the operations
launched inside the program's ``ff.etm.steps.backward`` ranges (the
backward of the per-step control matrices with their degenerate term,
their sum and the decay amplitudes, on autograd's thread), per pulse of
the traced window; left out where the program has no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.etm.steps.backward'))
