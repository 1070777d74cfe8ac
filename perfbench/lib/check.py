"""The comparison that decides ``correct``: the program's answers against
the plain reference's, on a sample of the window's calls drawn from the
seed."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from perfbench.lib import traffic


def sample_calls(sizes: Sequence, n: int, seed: int) -> List[int]:
    """Indices of *n* of the calls (all, if there are fewer), drawn from
    *seed*, the call of the largest size always among them."""
    count = len(sizes)
    rng = np.random.default_rng([int(seed) % traffic.SEED_MOD, 2 ** 34])
    if count <= n:
        return list(range(count))
    picked = set(int(i) for i in rng.choice(count, n, replace=False))
    if sizes[0] is not None:
        largest = max(range(count), key=lambda i: sizes[i])
        if sizes[largest] not in {sizes[i] for i in picked}:
            picked.discard(min(picked))
            picked.add(largest)
    return sorted(picked)


def rel_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest gap of a row's answers, as a share of the row's largest
    reference answer: max over rows of max |program - reference| /
    max |reference| (leading axis: rows)."""
    program = program.double().flatten(1)
    reference = reference.double().flatten(1).to(program.device)
    gap = (program - reference).abs().amax(-1)
    scale = reference.abs().amax(-1)
    return float((gap / scale).max())


def nonfinite(output: torch.Tensor, shape) -> bool:
    return tuple(output.shape) != tuple(shape) or \
        not bool(torch.isfinite(output).all())
