"""Entry ``functional.batched_infidelity``: a batch of jittered copies of
the configuration's pulse per call, on the default contraction route of
the card (``contract=None``), in chunks of ``chunk_size`` pulses.

Traced, a call replays the entry's chunk loop (``functional.
_batched_infidelity`` and ``_batched_stat``) with a span around each
chunk's prep and each chunk's contraction.  Set-up holds the replay
bit for bit against the entry; where it differs, or the program no
longer has the functions it replays, the traced calls go through the
entry and the prep and contraction spans are not there to read.
"""
from __future__ import annotations

import sys
from typing import List, Tuple

import torch

from perfbench.lib import check
from perfbench.lib.trace import Spans


class Entry:

    def __init__(self, data: dict, mix: dict, device, spans: Spans):
        from filter_functions_tpu_torch import config, functional
        self.functional = functional
        self.device = torch.device(device)
        self.spans = spans
        self.batch = int(mix['batch'])
        self.chunk = mix.get('chunk_size')
        arrays = data['arrays']
        as_dev = {name: torch.as_tensor(arrays[name], device=self.device)
                  for name in arrays}
        self.pulse = functional.PulseArrays(
            as_dev['c_opers'], as_dev['c_coeffs'], as_dev['n_opers'],
            as_dev['n_coeffs'].expand(self.batch, -1, -1).contiguous(),
            as_dev['dt'].expand(self.batch, -1).contiguous(), as_dev['basis'])
        self.omega = torch.as_tensor(data['omega'], device=self.device)
        self.spectrum = torch.as_tensor(data['spectrum'], device=self.device)
        self.n_nops = self.pulse.n_opers.shape[0]
        self.mode = config.contraction_mode(self.device, None)
        self.tol = config.ESCALATION_TOL
        self.replay_ok = False

    def pulses(self, call) -> int:
        return self.batch

    def shape(self, call) -> Tuple[int, ...]:
        return (self.batch, self.n_nops)

    def _arrays(self, call):
        scales = torch.as_tensor(call.inputs['scales'], device=self.device)
        return self.pulse._replace(c_coeffs=self.pulse.c_coeffs[None] * scales)

    def call(self, call) -> Tuple[torch.Tensor, ...]:
        p = self._arrays(call)
        if self.spans.enabled and self.replay_ok:
            return (self._replay(p),)
        return (self.functional.batched_infidelity(
            p, self.spectrum, self.omega, chunk_size=self.chunk),)

    # -- the traced replay -------------------------------------------------
    def _chunks(self, p, escalation: str):
        f, spans = self.functional, self.spans
        batch, d = p.c_coeffs.shape[0], p.c_opers.shape[-1]
        size = batch if self.chunk is None else min(self.chunk, batch)
        infids, ratios = [], []
        for start in range(0, batch, size):
            sl = slice(start, start + size)
            with spans('prep'):
                _, terms, degenerate = f._prep(p, p.c_coeffs[sl],
                                               p.n_coeffs[sl], p.dt[sl],
                                               self.omega)
            with spans('contraction'):
                infid, ratio = f._infid_contract(
                    terms, self.spectrum, self.omega, d, escalation,
                    self.mode, degenerate)
            infids.append(infid)
            ratios.append(ratio)
        return torch.cat(infids), torch.cat(ratios)

    def _replay(self, p) -> torch.Tensor:
        infid, ratios = self._chunks(p, 'stat')
        if self.functional._escalates(ratios, self.tol):
            infid, _ = self._chunks(p, 'force')
        return infid

    def prepare_trace(self, call) -> None:
        """Holds the replay bit for bit against the entry on *call*."""
        p = self._arrays(call)
        try:
            want = self.functional.batched_infidelity(
                p, self.spectrum, self.omega, chunk_size=self.chunk)
            got = self._replay(p)
        except AttributeError as err:
            print(f'replay of the chunk loop unavailable ({err}): no prep '
                  'or contraction spans', file=sys.stderr)
            return
        self.replay_ok = bool(torch.equal(want, got))
        if not self.replay_ok:
            print('replay of the chunk loop differs from '
                  'functional.batched_infidelity: no prep or contraction '
                  'spans', file=sys.stderr)

    def release(self) -> None:
        del self.pulse

    # -- the comparison ----------------------------------------------------
    def control(self, done: List, reference) -> List:
        """The sampled calls with the control's answers in place of the
        program's: the reference one precision lower."""
        return [(c, (reference.infidelities(c.inputs, 'float32'),))
                for c, _ in done]

    def compare(self, done: List, reference) -> dict:
        program = torch.cat([outputs[0] for _, outputs in done])
        want = torch.cat([reference.infidelities(c.inputs) for c, _ in done])
        return {'infid_rel_gap': check.rel_gap(program, want)}
