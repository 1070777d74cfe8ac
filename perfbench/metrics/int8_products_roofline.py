"""``int8_products_roofline``: the share of the card's dense int8 peak
that the Ozaki slice products reach in the traced window: the program's
count of their int8 operations (``ozaki.int8_ops`` of
``filter_functions_tpu_torch.tracing``, 3 B sum_pairs 2 M K N a call of
``ops.ozaki._outer_contract``, unpadded) over the device time of the
operations launched inside its ``ff.ozaki.products`` spans, against
1979 T int8 operations/s.  Left out where the program has no such
counter or span."""
from perfbench.metrics import _program

#: Dense int8 peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
#: 700 W limit), operations/s.
INT8_PEAK_OPS_PER_S = 1.979e15

instrument = _program.instrument


def read(run):
    counts = run.counters.get(_program.COUNTS)
    if not counts or not counts.get('ozaki.int8_ops'):
        return None
    seconds = _program.launched_under_s(run.trace, 'ff.ozaki.products')
    if not seconds:
        return None
    return 100.0 * counts['ozaki.int8_ops'] / seconds / INT8_PEAK_OPS_PER_S
