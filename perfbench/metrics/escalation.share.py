"""``escalation.share``: the share of the program's escalation decisions
in the traced window that recomputed at full precision
(``escalation.escalated`` over ``escalation.decisions`` of
``filter_functions_tpu_torch.tracing``); left out where none was
made."""
from perfbench.metrics import _program

instrument = _program.instrument


def read(run):
    counts = run.counters.get(_program.COUNTS)
    if not counts or not counts.get('escalation.decisions'):
        return None
    return 100.0 * counts.get('escalation.escalated', 0) \
        / counts['escalation.decisions']
