"""Plain reference of the ``rb1q`` configuration: single-qubit Clifford
randomized benchmarking under Z dephasing.

Each sequence is laid out segment by segment from the Cliffords' words
in {X90, Y90, X-90, Y-90} (the identity is one idle segment; a word of
n generators takes n segments of tau / n), and its infidelity is worked
out from scratch by :mod:`reference.piecewise`: none of the 24 atomic
control matrices or transfer matrices that the program caches and
composes is used.  Sequences of a call are padded with segments of zero
duration, which add nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.lib.traffic import clifford_group
from perfbench.reference import piecewise

_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]])
_Z = np.diag([1.0 + 0j, -1.0])
#: The normalized Pauli basis {I, X, Y, Z} / sqrt(2).
_PAULI = np.stack([np.eye(2, dtype=complex), _X, _Y, _Z]) / np.sqrt(2)


def clifford_segments(tau: float):
    """Per Clifford, (amplitudes (2, g), durations (g,)) of its
    segments."""
    out = []
    for _, word in clifford_group():
        if not word:
            out.append((np.zeros((2, 1)), np.array([tau])))
            continue
        seg = tau / len(word)
        amps = np.zeros((2, len(word)))
        for g, name in enumerate(word):
            sign = -1 if '-' in name else 1
            amps[0 if name.startswith('X') else 1, g] = sign * np.pi / 2 / seg
        out.append((amps, np.full(len(word), seg)))
    return out


class Reference:
    """The inputs of both sides (host arrays from the harness) on
    *device*, and the reference's answers for a call's inputs."""

    def __init__(self, data: dict, device):
        self.device = torch.device(device)
        self.tau = float(data['config']['tau'])
        self.segments = clifford_segments(self.tau)
        self.omega = torch.as_tensor(data['omega'], device=device)
        self.spectrum = torch.as_tensor(data['spectrum'], device=device)
        self.c_opers = torch.as_tensor(np.stack([_X, _Y]) / 2, device=device)
        self.n_opers = torch.as_tensor((_Z / 2)[None], device=device)
        self.basis = torch.as_tensor(_PAULI, device=device)

    def layout(self, indices: np.ndarray):
        """(c_coeffs (S, 2, G), n_coeffs (S, 1, G), dt (S, G)) of the
        sequences *indices* (S, L), padded to the longest."""
        per_seq = [[self.segments[i] for i in row] for row in indices]
        G = max(sum(len(dt) for _, dt in row) for row in per_seq)
        c = np.zeros((len(per_seq), 2, G))
        dt = np.zeros((len(per_seq), G))
        for s, row in enumerate(per_seq):
            amps = np.concatenate([a for a, _ in row], axis=1)
            steps = np.concatenate([t for _, t in row])
            c[s, :, :amps.shape[1]] = amps
            dt[s, :steps.shape[0]] = steps
        return c, np.ones((len(per_seq), 1, G)), dt

    def infidelities(self, inputs: dict, precision: str = 'float64'
                     ) -> torch.Tensor:
        """(S, 1) infidelities of a call's sequences."""
        c, n, dt = (torch.as_tensor(x, device=self.device)
                    for x in self.layout(inputs['indices']))
        return piecewise.infidelity(self.c_opers, c, self.n_opers, n, dt,
                                    self.basis, self.omega, self.spectrum,
                                    precision)
