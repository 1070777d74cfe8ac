"""``device.kernels_per_pulse``: the kernels that ran on the card in the
traced window, per pulse evaluated there: an exact count of launches,
which fusion lowers."""


def read(run):
    trace = run.trace
    if trace is None or trace.window is None or not run.pulses:
        return None
    return len(trace.kernels_in_window()) / run.pulses
