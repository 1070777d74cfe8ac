"""Entry ``functional.batched_error_transfer_matrix`` under a
cross-spectrum: the calls of :mod:`entries.error_transfer_matrix` (a
batch of jittered copies of the configuration's pulse, their error
transfer matrices to second order, span ``etm``, the same comparison),
given the spectrum S_ab(w) = C_ab A / w^p of the configuration's
``correlations`` in place of the diagonal one.  S is built on the card
once, at set-up: C is 1 on the diagonal and rho^|j - k| between the
correlated operators at chain positions j and k.
"""
from __future__ import annotations

import torch

from perfbench.entries.error_transfer_matrix import Entry as _Diagonal


class Entry(_Diagonal):

    def __init__(self, data: dict, mix: dict, device, spans):
        super().__init__(data, mix, device, spans)
        corr = data['config']['correlations']
        c = torch.eye(data['config']['n_nops'], dtype=self.spectrum.dtype,
                      device=self.device)
        idx = torch.as_tensor(corr['indices'], device=self.device)
        pos = torch.as_tensor(corr['positions'], dtype=c.dtype,
                              device=self.device)
        c[idx[:, None], idx[None, :]] = \
            corr['rho'] ** (pos[:, None] - pos[None, :]).abs()
        self.spectrum = c[:, :, None] * self.spectrum[None, None, :]
