"""Entry ``models.rb.batched_rb_infidelities``: a batch of random Clifford
sequences of one length (each with its recovery gate) per call, on the
card.  Set-up fills the program's cache of the 24 atomic Cliffords,
which every call reads."""
from __future__ import annotations

from typing import List, Tuple

import torch

from perfbench.lib import check
from perfbench.lib.trace import Spans


class Entry:

    def __init__(self, data: dict, mix: dict, device, spans: Spans):
        from filter_functions_tpu_torch.models import rb
        self.rb = rb
        self.device = torch.device(device)
        self.spans = spans
        self.batch = int(mix['batch'])
        self.tau = float(data['config']['tau'])
        self.omega = data['omega']
        self.spectrum = data['spectrum']

    def pulses(self, call) -> int:
        return self.batch

    def shape(self, call) -> Tuple[int, ...]:
        return (self.batch,)

    def call(self, call) -> Tuple[torch.Tensor, ...]:
        return (self.rb.batched_rb_infidelities(
            call.inputs['indices'], self.omega, self.spectrum, tau=self.tau,
            device=self.device),)

    def prepare_trace(self, call) -> None:
        pass

    def release(self) -> None:
        self.rb._atomic_clifford_data.cache_clear()

    def control(self, done: List, reference) -> List:
        """The sampled calls with the control's answers in place of the
        program's: the reference one precision lower."""
        return [(c, (reference.infidelities(c.inputs, 'float32')[:, 0],))
                for c, _ in done]

    def compare(self, done: List, reference) -> dict:
        """Every sequence's infidelity against its own reference value."""
        program = torch.cat([outputs[0] for _, outputs in done])
        want = torch.cat([reference.infidelities(c.inputs)[:, 0]
                          for c, _ in done])
        return {'infid_rel_gap': check.rel_gap(program[:, None],
                                               want[:, None])}
