"""``prep.ms_per_pulse``: device time of the operations launched inside
the spans around each chunk's prep (``functional._prep``: the
Hamiltonians, ``eigh``, the propagators and the per-segment step terms),
per pulse of the traced window."""


def read(run):
    if run.trace is None or not run.pulses:
        return None
    seconds = run.trace.span_device_s('prep')
    return None if seconds is None else 1e3 * seconds / run.pulses
