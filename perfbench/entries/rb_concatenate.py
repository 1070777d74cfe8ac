"""Entry ``models.rb.rb_pulse`` then ``numeric.infidelity``: the object
API of the upstream randomized-benchmarking example.  Each sequence of
a call is composed with ``sequencing.concatenate`` from the 24 Clifford
``PulseSequence``s, whose filter functions set-up caches on the card,
and its infidelity is read from the composed pulse.

Traced, the composition and the infidelity each run in a span.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from perfbench.entries import batched_rb
from perfbench.lib.trace import Spans


class Entry(batched_rb.Entry):

    def __init__(self, data: dict, mix: dict, device, spans: Spans):
        super().__init__(data, mix, device, spans)
        import filter_functions_tpu_torch as fft
        self.infidelity = fft.infidelity
        self.cliffords = self.rb.clifford_pulses(
            tau=self.tau, omega=self.omega, device=self.device)

    def call(self, call) -> Tuple[torch.Tensor, ...]:
        out = []
        for row in call.inputs['indices']:
            with self.spans('concatenate'):
                seq = self.rb.rb_pulse([int(i) for i in row[:-1]],
                                       int(row[-1]), self.cliffords)
            with self.spans('infidelity'):
                out.append(self.infidelity(seq, self.spectrum, self.omega))
        return (torch.cat(out),)

    def release(self) -> None:
        del self.cliffords
