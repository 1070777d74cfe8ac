"""``concatenate.ms_per_pulse``: host time of the spans around the
composition of each sequence (``models.rb.rb_pulse``, that is
``sequencing.concatenate`` of the cached Clifford pulses), per sequence
of the traced window."""


def read(run):
    times = run.spans.host_s.get('concatenate')
    if not times or not run.pulses:
        return None
    return 1e3 * sum(times) / run.pulses
