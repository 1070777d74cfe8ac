"""Entry ``functional.batched_error_transfer_matrix``: a batch of
jittered copies of the configuration's pulse per call, their error
transfer matrices to the configuration's order (``order``, 2: with the
frequency shifts) for its diagonal spectrum, on the card.  Each call
runs in the benchmark's span ``etm``.

The comparison holds E - I (the whole process less the identity) and
the antisymmetric part (E - E^T) / 2, which the first order leaves zero
and the frequency shifts make, each against the plain reference.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from perfbench.lib import check
from perfbench.lib.trace import Spans


def coherent(etm: torch.Tensor) -> torch.Tensor:
    """The antisymmetric part (E - E^T) / 2 of matrices (..., n, n)."""
    return (etm - etm.mT) / 2


class Entry:

    def __init__(self, data: dict, mix: dict, device, spans: Spans):
        from filter_functions_tpu_torch import functional
        from filter_functions_tpu_torch.basis import Basis
        self.functional = functional
        self.device = torch.device(device)
        self.spans = spans
        self.batch = int(mix['batch'])
        self.second_order = int(data['config']['order']) == 2
        arrays = data['arrays']
        self.basis = Basis(arrays['basis'])
        as_dev = {name: torch.as_tensor(arrays[name], device=self.device)
                  for name in arrays}
        self.pulse = functional.PulseArrays(
            as_dev['c_opers'], as_dev['c_coeffs'], as_dev['n_opers'],
            as_dev['n_coeffs'].expand(self.batch, -1, -1).contiguous(),
            as_dev['dt'].expand(self.batch, -1).contiguous(),
            self.basis.tensor(self.device))
        self.omega = torch.as_tensor(data['omega'], device=self.device)
        self.spectrum = torch.as_tensor(data['spectrum'], device=self.device)

    def pulses(self, call) -> int:
        return self.batch

    def shape(self, call) -> Tuple[int, ...]:
        n_b = len(self.basis)
        return (self.batch, n_b, n_b)

    def call(self, call) -> Tuple[torch.Tensor, ...]:
        scales = torch.as_tensor(call.inputs['scales'], device=self.device)
        p = self.pulse._replace(c_coeffs=self.pulse.c_coeffs[None] * scales)
        with self.spans('etm'):
            return (self.functional.batched_error_transfer_matrix(
                p, self.spectrum, self.omega, self.basis,
                second_order=self.second_order),)

    def prepare_trace(self, call) -> None:
        pass

    def release(self) -> None:
        del self.pulse

    # -- the comparison ----------------------------------------------------
    def control(self, done: List, reference) -> List:
        """The sampled calls with the control's answers in place of the
        program's: the reference one precision lower."""
        return [(c, (reference.error_transfer_matrices(
            c.inputs, 'float32', self.second_order),)) for c, _ in done]

    def compare(self, done: List, reference) -> dict:
        """E - I and (E - E^T) / 2 of every row of the sampled calls,
        each against the reference's."""
        program = torch.cat([outputs[0] for _, outputs in done]).double()
        want = torch.cat([reference.error_transfer_matrices(
            c.inputs, 'float64', self.second_order) for c, _ in done])
        program = program.to(want.device)
        eye = torch.eye(want.shape[-1], dtype=want.dtype, device=want.device)
        return {'etm_rel_gap': check.rel_gap(program - eye, want - eye),
                'coherent_rel_gap': check.rel_gap(coherent(program),
                                                  coherent(want))}
