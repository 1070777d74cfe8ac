"""``prep.backward.ms_per_pulse``: device time of the operations
launched inside the program's ``ff.prep.backward`` ranges (the backward
of the eigendecomposition, the propagators and the degenerate terms of
prep, on autograd's thread), per pulse of the traced window; left out
where the program has no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.prep.backward'))
