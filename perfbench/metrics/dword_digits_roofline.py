"""``dword_digits_roofline``: the share of its memory floor that the
``dword_digits`` kernel reaches in the traced window: the floor of each
launch at its own shapes (:func:`perfbench.lib.roofline.
dword_digits_bound_s`), summed, over the device time of the kernels
whose name holds ``dword_digits``.

The shapes come from a wrapper around the program's
``ops.dword.dword_digits`` that records each call's (B, K, J, C, n_d)
and calls through."""
from perfbench.lib import roofline

COUNTER = 'dword_digits.launch_shapes'


def instrument(run):
    from filter_functions_tpu_torch.ops import dword
    original = dword.dword_digits
    shapes = run.counters.setdefault(COUNTER, [])

    def recorded(zbr, zbi, zcr, zci, n_d, slice_bits):
        if zbr.device.type == 'cuda':
            B, K, J = zbr.shape
            shapes.append((B, K, J, zcr.shape[-1], n_d))
        return original(zbr, zbi, zcr, zci, n_d, slice_bits)

    dword.dword_digits = recorded
    return lambda: setattr(dword, 'dword_digits', original)


def read(run):
    shapes = run.counters.get(COUNTER)
    if run.trace is None or not shapes:
        return None
    seconds, count = run.trace.device_s_by_name('dword_digits')
    if not count or count != len(shapes):
        return None
    bound = sum(roofline.dword_digits_bound_s(K, J, C, n_d, B)
                for B, K, J, C, n_d in shapes)
    return 100.0 * bound / seconds
