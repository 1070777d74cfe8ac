"""Conversion of the JAX package's pulse parameters, given as numpy
arrays, into the port's :class:`~.functional.PulseArrays`.

Two sources are accepted:

* a mapping in the layout of ``filter_functions_tpu/models/*.npz``: the
  complex fields split into ``<name>_re`` / ``<name>_im`` arrays (a
  complex array under ``<name>`` itself is taken too), the real fields
  under their own names;
* a ``filter_functions_tpu.functional.PulseArrays`` whose leaves were
  turned into numpy arrays, so that its complex fields are split-complex
  objects with ``.re`` and ``.im`` arrays.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from . import config
from .functional import PulseArrays

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
                            device: Union[str, torch.device] = 'cpu'
                            ) -> PulseArrays:
    """:class:`~.functional.PulseArrays` on *device* from the JAX
    package's parameters given as numpy arrays (see the module
    docstring for the accepted layouts)."""
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
