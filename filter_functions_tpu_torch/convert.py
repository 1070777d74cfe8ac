"""Conversion of the JAX package's pulses, given as numpy arrays, into
the port's objects.

:func:`pulse_arrays_from_numpy` builds a :class:`~.functional.
PulseArrays` from

* a mapping in the layout of ``filter_functions_tpu/models/*.npz``: the
  complex fields split into ``<name>_re`` / ``<name>_im`` arrays (a
  complex array under ``<name>`` itself is taken too), the real fields
  under their own names;
* a ``filter_functions_tpu.functional.PulseArrays`` whose leaves were
  turned into numpy arrays, so that its complex fields are split-complex
  objects with ``.re`` and ``.im`` arrays.

:func:`pulse_sequence_from_numpy` and :func:`basis_from_numpy` build a
:class:`~.pulse_sequence.PulseSequence` and a :class:`~.basis.Basis`
from the JAX package's objects, read through their host numpy
attributes, or from mappings of those arrays.  Nothing here imports JAX.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from . import config
from .basis import Basis
from .functional import PulseArrays
from .pulse_sequence import PulseSequence
from .types import Device

#: The host arrays that define a pulse, in ``from_arrays`` order.
PULSE_FIELDS = ('c_opers', 'c_oper_identifiers', 'c_coeffs', 'n_opers',
                'n_oper_identifiers', 'n_coeffs', 'dt')

_COMPLEX_FIELDS = ('c_opers', 'n_opers', 'basis')


def _field(source: Any, name: str) -> Any:
    if hasattr(source, '_fields'):
        return getattr(source, name)
    if name in source:
        return source[name]
    return (source[f'{name}_re'], source[f'{name}_im'])


def _complex(value: Any) -> np.ndarray:
    if isinstance(value, tuple):
        re, im = value
    elif hasattr(value, 're') and hasattr(value, 'im'):
        re, im = value.re, value.im
    else:
        return np.asarray(value, dtype=np.complex128)
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def pulse_arrays_from_numpy(source: Any,
                            device: Device = config.DEFAULT_DEVICE
                            ) -> PulseArrays:
    """:class:`~.functional.PulseArrays` on *device* from the JAX
    package's parameters given as numpy arrays (see the module
    docstring for the accepted layouts)."""
    device = config.resolve_device(device)
    leaves = {}
    for name in PulseArrays._fields:
        value = _field(source, name)
        if name in _COMPLEX_FIELDS:
            leaves[name] = torch.tensor(_complex(value),
                                        dtype=config.COMPLEX, device=device)
        else:
            leaves[name] = torch.tensor(np.asarray(value, np.float64),
                                        dtype=config.REAL, device=device)
    return PulseArrays(**leaves)


def basis_from_numpy(source: Any) -> Basis:
    """The port's :class:`~.basis.Basis` from a JAX ``Basis`` (its
    ``np`` master copy, ``btype`` and ``labels``) or from an array of
    elements."""
    if hasattr(source, 'np'):
        return Basis(np.asarray(source.np), btype=source.btype,
                     labels=source.labels, skip_checks=True)
    return Basis(np.asarray(source), skip_checks=True)


def pulse_sequence_from_numpy(source: Any,
                              device: Device = config.DEFAULT_DEVICE
                              ) -> PulseSequence:
    """The port's :class:`~.pulse_sequence.PulseSequence` on *device*
    from a JAX ``PulseSequence`` (its host attributes) or from a
    mapping of :data:`PULSE_FIELDS` and ``basis``, taken in their order
    as ``from_arrays`` takes them."""
    if isinstance(source, Mapping):
        fields = [source[name] for name in PULSE_FIELDS]
        basis = source['basis']
    else:
        fields = [getattr(source, name) for name in PULSE_FIELDS]
        basis = source.basis
    return PulseSequence.from_arrays(*fields, basis=basis_from_numpy(basis),
                                     device=device)
