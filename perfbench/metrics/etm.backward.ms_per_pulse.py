"""``etm.backward.ms_per_pulse``: device time of the operations launched
inside the entry's spans around ``torch.autograd.grad`` of the second-order
error transfer matrices' loss (every backward node of the ETM, the K2
tables' rebuild and the degenerate terms among them), per pulse of the
traced window."""


def read(run):
    if run.trace is None or not run.pulses:
        return None
    seconds = run.trace.span_device_s('backward')
    return None if seconds is None else 1e3 * seconds / run.pulses
