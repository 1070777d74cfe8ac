"""``device.idle_pct``: the share of the traced window in which no
operation runs on the card.  The window runs from the start of the first
call to the end of the last; the busy time is the union of the device
operations' intervals in it."""


def read(run):
    trace = run.trace
    if trace is None or trace.window is None or not trace.window_s():
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())
