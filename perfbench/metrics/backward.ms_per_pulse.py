"""``backward.ms_per_pulse``: device time of the operations launched
inside the spans around ``torch.autograd.grad`` (the autograd nodes
``_OzakiOuter``, ``_Eigh`` and the degenerate terms), per pulse of the
traced window."""


def read(run):
    if run.trace is None or not run.pulses:
        return None
    seconds = run.trace.span_device_s('backward')
    return None if seconds is None else 1e3 * seconds / run.pulses
