"""``so.tables.ms_per_pulse``: device time of the operations launched
inside the program's ``ff.so.tables`` spans (each chunk's weighted K2
lattice of the second-order frequency shifts: on the card the tables
kernel, its DGEMM and its epilogue), per pulse of the traced window;
left out where the program has no such span."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.so.tables'))
