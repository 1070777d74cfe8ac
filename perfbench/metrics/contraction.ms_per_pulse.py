"""``contraction.ms_per_pulse``: device time of the operations launched
inside the spans around each chunk's contraction
(``functional._infid_contract``: the Ozaki route with ``dword_digits``,
the int8 slice products and their recombination, and the frequency
integral), per pulse of the traced window."""


def read(run):
    if run.trace is None or not run.pulses:
        return None
    seconds = run.trace.span_device_s('contraction')
    return None if seconds is None else 1e3 * seconds / run.pulses
