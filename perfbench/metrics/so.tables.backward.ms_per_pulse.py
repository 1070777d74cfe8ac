"""``so.tables.backward.ms_per_pulse``: device time of the operations
launched inside the program's ``ff.so.tables.backward`` spans (each
sub-chunk of the second-order shifts' K2 tables rebuilt under autograd
and its vector-Jacobian product, on autograd's thread), per pulse of
the traced window; left out where the program has no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.so.tables.backward'))
