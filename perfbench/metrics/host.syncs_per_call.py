"""``host.syncs_per_call``: the program's reads of the device in the
traced window (the ``sync.*`` counters of
``filter_functions_tpu_torch.tracing``: the escalation decision, the
degenerate-eigenspace check, the chunked control matrix's escalation,
``_expm``'s norm), per call."""
from perfbench.metrics import _program

instrument = _program.instrument


def read(run):
    counts = run.counters.get(_program.COUNTS)
    if counts is None or run.trace is None:
        return None
    calls = _program.calls(run.trace)
    if not calls:
        return None
    syncs = sum(v for k, v in counts.items() if k.startswith('sync.'))
    return syncs / calls
