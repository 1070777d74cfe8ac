"""Entry ``functional.batched_infidelity`` then ``torch.autograd.grad``
of the summed infidelities in the control amplitudes: a GRAPE step's
forward and backward for a batch of jittered copies of the
configuration's pulse, on the default contraction route of the card.

Traced, the forward and the backward each run in a span.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from perfbench.entries import batched_infidelity
from perfbench.lib import check


class Entry(batched_infidelity.Entry):

    def call(self, call) -> Tuple[torch.Tensor, ...]:
        p = self._arrays(call)
        coeffs = p.c_coeffs.detach().requires_grad_(True)
        with self.spans('forward'):
            infid = self.functional.batched_infidelity(
                p._replace(c_coeffs=coeffs), self.spectrum, self.omega,
                chunk_size=self.chunk)
        with self.spans('backward'):
            grad, = torch.autograd.grad(infid.sum(), coeffs)
        return infid.detach(), grad

    def prepare_trace(self, call) -> None:
        pass

    def control(self, done: List, reference) -> List:
        """As the program's: the gradient of the first call only, which
        is the one compared."""
        out = super().control(done, reference)
        first, (infid,) = out[0]
        out[0] = (first, (infid, reference.gradient(
            first.inputs, range(self.batch), 'float32')))
        return out

    def compare(self, done: List, reference) -> dict:
        """The infidelities of every sampled call; the gradient of the
        first sampled call's rows (the reference's central differences
        cost 4 x n_ctrl x G evaluations a row)."""
        numbers = super().compare(done, reference)
        call, outputs = done[0]
        want = reference.gradient(call.inputs, range(self.batch))
        numbers['grad_rel_gap'] = check.rel_gap(outputs[1], want)
        return numbers
