"""``so.mix.ms_per_pulse``: device time of the operations launched
inside the program's ``ff.so.mix`` spans (a cross-spectrum's mixing of
the correlated noise operators, in the decay amplitudes and in the
frequency shifts) and ``ff.spectrum.profiles`` spans (the spectrum's
read to the host and the upload of its profiles and factors), per pulse
of the traced window; left out where the program has neither span."""
from perfbench.metrics import _program

SPANS = ('ff.so.mix', 'ff.spectrum.profiles')


def read(run):
    found = [s for s in (_program.launched_under_s(run.trace, name)
                         for name in SPANS) if s is not None]
    return _program.per_pulse_ms(run, sum(found) if found else None)
