"""``ozaki.products.ms_per_pulse``: device time of the operations
launched inside the program's ``ff.ozaki.products`` spans
(``ops.ozaki._outer_contract``: the three Gauss products' int8 slice
GEMMs and their double-single recombination), per pulse."""
from perfbench.metrics import _program


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, 'ff.ozaki.products'))
