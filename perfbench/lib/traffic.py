"""The general traffic generator.

A traffic mix is a JSON file of parameters, ``perfbench/traffic/<mix>.json``:

* ``entry``: the program entry that each call drives
  (``perfbench/entries/<entry>.py``);
* ``batch``: pulses per call; ``chunk_size``: passed to the entry;
* ``sizes_from``: the key of a list in the configuration (such as
  ``lengths``) that the calls cycle through, each cycle in a fresh order
  drawn from the seed, so that every seed sends the same sizes in a
  different order; without it every call has one size;
* ``draw``: what each call's inputs are, ``amplitude_jitter`` (every
  row's control amplitudes scaled by 1 + ``jitter`` N(0, 1), as the
  flagship's robustness batch) or ``clifford_sequences`` (``batch``
  random Clifford sequences of the call's length, each with its
  recovery gate).

The calls are one closed loop: a single caller sends the next call when
the previous one has returned.  Call i draws from its own generator,
``numpy.random.default_rng([seed, i])``, so the inputs depend on the
seed and the call's index only.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

SEED_MOD = 2 ** 64


class Call(NamedTuple):
    """One call of the closed loop: its index, its size and its inputs."""
    index: int
    size: Optional[int]
    inputs: dict


def load_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    for key in ('entry', 'batch', 'draw'):
        if key not in mix:
            raise ValueError(f'traffic mix {path} lacks {key!r}')
    if mix['draw'] not in DRAWS:
        raise ValueError(f'traffic mix {path}: unknown draw {mix["draw"]!r}'
                         f' (known: {sorted(DRAWS)})')
    return mix


def call_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % SEED_MOD, int(index)])


def size_order(sizes: Sequence[int], seed: int) -> Iterator[int]:
    """The sizes in cycles, each cycle a fresh permutation from *seed*."""
    rng = np.random.default_rng([int(seed) % SEED_MOD, 2 ** 32])
    sizes = list(sizes)
    while True:
        for i in rng.permutation(len(sizes)):
            yield sizes[i]


def calls(mix: dict, config: dict, seed: int) -> Iterator[Call]:
    """The calls of one run, without end."""
    sizes = config[mix['sizes_from']] if 'sizes_from' in mix else None
    order = size_order(sizes, seed) if sizes is not None else None
    draw = DRAWS[mix['draw']]
    index = 0
    while True:
        size = next(order) if order is not None else None
        yield Call(index, size, draw(mix, size, call_rng(seed, index)))
        index += 1


def distinct_calls(mix: dict, config: dict, seed: int) -> List[Call]:
    """One call of each size the run sends (the warm-up's shapes), drawn
    apart from the window's calls."""
    sizes = config[mix['sizes_from']] if 'sizes_from' in mix else [None]
    draw = DRAWS[mix['draw']]
    return [Call(-1 - i, size, draw(mix, size, call_rng(seed, 2 ** 33 + i)))
            for i, size in enumerate(sizes)]


# -----------------------------------------------------------------------------
# Draws
# -----------------------------------------------------------------------------
def jitter_scales(rng: np.random.Generator, batch: int,
                  jitter: float) -> np.ndarray:
    """(batch, 1, 1) factors 1 + jitter N(0, 1) of each row's control
    amplitudes: the flagship's robustness batch, every row jittered."""
    return 1 + jitter * rng.standard_normal((batch, 1, 1))


def _amplitude_jitter(mix, size, rng):
    return {'scales': jitter_scales(rng, mix['batch'], mix['jitter'])}


_I = np.eye(2, dtype=complex)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]])
_GENERATORS = (('X90', _X, 1), ('Y90', _Y, 1), ('X-90', _X, -1),
               ('Y-90', _Y, -1))


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    return np.cos(angle / 2) * _I - 1j * np.sin(angle / 2) * axis


def _phase_equal(u: np.ndarray, v: np.ndarray) -> bool:
    return abs(abs(np.trace(u.conj().T @ v)) - u.shape[0]) < 1e-9


def _find(group, v) -> int:
    for i, (u, _) in enumerate(group):
        if _phase_equal(u, v):
            return i
    return -1


@functools.lru_cache(maxsize=None)
def clifford_group() -> Tuple[Tuple[np.ndarray, Tuple[str, ...]], ...]:
    """The 24 single-qubit Cliffords, each with a shortest word in
    {X90, Y90, X-90, Y-90}, in the order of a breadth-first closure from
    the identity (the order of ``models.rb.clifford_group``)."""
    group = [(_I.copy(), ())]
    frontier = list(group)
    while frontier:
        grown = []
        for u, word in frontier:
            for name, axis, sign in _GENERATORS:
                v = _rotation(axis, sign * np.pi / 2) @ u
                if _find(group, v) < 0:
                    group.append((v, word + (name,)))
                    grown.append(group[-1])
        frontier = grown
    if len(group) != 24:
        raise AssertionError(f'Clifford closure gave {len(group)} elements')
    return tuple(group)


@functools.lru_cache(maxsize=None)
def clifford_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(product, inverse): ``product[i, j]`` is the index of Clifford i
    times Clifford j, ``inverse[i]`` that of Clifford i's inverse."""
    group = clifford_group()
    product = np.array([[_find(group, u @ v) for v, _ in group]
                        for u, _ in group], dtype=np.int64)
    inverse = np.array([_find(group, u.conj().T) for u, _ in group],
                       dtype=np.int64)
    return product, inverse


def sample_sequences(batch: int, length: int, rng: np.random.Generator
                     ) -> np.ndarray:
    """(batch, length + 1) Clifford indices: *length* random ones and the
    recovery gate of each row, the inverse of the row's product, composed
    by table (``models.rb.sample_sequence`` multiplies matrices)."""
    product, inverse = clifford_tables()
    flat = product.ravel()
    indices = rng.integers(0, 24, (batch, length))
    # the product of each row, later gates on the left, as a tree of
    # pairwise products; an odd row gets the identity (index 0) last
    total = indices
    while total.shape[1] > 1:
        if total.shape[1] % 2:
            total = np.concatenate(
                [total, np.zeros((batch, 1), dtype=np.int64)], axis=1)
        total = flat.take(total[:, 1::2] * 24 + total[:, 0::2])
    return np.concatenate([indices, inverse.take(total)], axis=1)


def _clifford_sequences(mix, size, rng):
    return {'indices': sample_sequences(mix['batch'], size, rng)}


DRAWS = {'amplitude_jitter': _amplitude_jitter,
         'clifford_sequences': _clifford_sequences}
