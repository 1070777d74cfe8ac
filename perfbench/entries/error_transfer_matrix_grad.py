"""Entry ``functional.batched_error_transfer_matrix`` then
``torch.autograd.grad`` of the rows' summed loss sum_r ||E_r - I||_F^2
in the control amplitudes: a robust GRAPE step on the second-order
process of a batch of jittered copies of the configuration's pulse, on
the card.  Traced, the forward (with the loss) and the backward each
run in a span, ``forward`` and ``backward``; each call returns the
matrices and the gradient.

The comparison holds E - I, each row's loss, and the gradient's
derivatives (grad . v) along the mix's ``directions`` directions v a
row against the reference's central differences.  The directions are
orthonormal in each row's (n_ctrl x G) amplitudes, drawn from a
generator seeded with the bits of the call's jitter, which the run's
seed draws.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from perfbench.entries.error_transfer_matrix import Entry as _Etm
from perfbench.lib import check


class Entry(_Etm):

    def __init__(self, data: dict, mix: dict, device, spans):
        super().__init__(data, mix, device, spans)
        self.n_directions = int(mix['directions'])
        self.amplitudes = tuple(self.pulse.c_coeffs.shape)   # (n_ctrl, G)
        self.eye = torch.eye(len(self.basis), dtype=torch.float64,
                             device=self.device)

    def call(self, call) -> Tuple[torch.Tensor, ...]:
        scales = torch.as_tensor(call.inputs['scales'], device=self.device)
        coeffs = (self.pulse.c_coeffs[None] * scales).requires_grad_(True)
        with self.spans('forward'):
            etm = self.functional.batched_error_transfer_matrix(
                self.pulse._replace(c_coeffs=coeffs), self.spectrum,
                self.omega, self.basis, second_order=self.second_order)
            loss = ((etm - self.eye) ** 2).sum()
        with self.spans('backward'):
            grad, = torch.autograd.grad(loss, coeffs)
        return etm.detach(), grad

    def directions(self, call) -> torch.Tensor:
        """(batch, m, n_ctrl, G) directions of a call, orthonormal in each
        row's amplitudes."""
        n_ctrl, G = self.amplitudes
        rng = np.random.default_rng(np.frombuffer(
            np.ascontiguousarray(call.inputs['scales']).tobytes(),
            dtype=np.uint32))
        q, _ = np.linalg.qr(rng.standard_normal(
            (self.batch, n_ctrl * G, self.n_directions)))
        return torch.as_tensor(q.transpose(0, 2, 1).reshape(
            self.batch, self.n_directions, n_ctrl, G), device=self.device)

    # -- the comparison ----------------------------------------------------
    def control(self, done: List, reference) -> List:
        """The sampled calls with the control's answers in place of the
        program's: the reference in float32, its gradient the sum of its
        directional derivatives times the (orthonormal) directions."""
        out = []
        for c, _ in done:
            v = self.directions(c)
            slopes = reference.directional_derivatives(c.inputs, v,
                                                       'float32')
            out.append((c, (reference.error_transfer_matrices(
                c.inputs, 'float32'),
                torch.einsum('rj,rjkg->rkg', slopes, v.to(slopes.device)))))
        return out

    def compare(self, done: List, reference) -> dict:
        """E - I and the loss of every row of the sampled calls, and the
        gradient's derivative along each direction of a row, each against
        the reference's."""
        etm, want, slopes, want_slopes = [], [], [], []
        for c, (e, grad) in done:
            v = self.directions(c)
            etm.append(e.double())
            want.append(reference.error_transfer_matrices(c.inputs))
            slopes.append(torch.einsum('rkg,rjkg->rj', grad.double(),
                                       v.to(grad.device)))
            want_slopes.append(reference.directional_derivatives(c.inputs,
                                                                 v))
        want = torch.cat(want)
        etm = torch.cat(etm).to(want.device)
        eye = torch.eye(want.shape[-1], dtype=want.dtype, device=want.device)

        def loss(x):
            return ((x - eye) ** 2).sum((-2, -1))[:, None]
        return {'etm_rel_gap': check.rel_gap(etm - eye, want - eye),
                'loss_rel_gap': check.rel_gap(loss(etm), loss(want)),
                'graddir_rel_gap': check.rel_gap(
                    torch.cat(slopes).to(want.device),
                    torch.cat(want_slopes))}
