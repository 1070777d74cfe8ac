"""``backward.ozaki.ms_per_pulse``: device time of the operations
launched inside autograd's ranges around the backward node of the
factored Ozaki product (``ops.ozaki._OzakiOuter``: its complex128
products), per pulse."""
from perfbench.metrics import _program

NODE = 'autograd::engine::evaluate_function: _OzakiOuterBackward'


def read(run):
    return _program.per_pulse_ms(
        run, _program.launched_under_s(run.trace, NODE))
