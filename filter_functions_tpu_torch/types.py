"""Type aliases of the PyTorch port (counterparts of
``filter_functions_tpu.types``, structural only)."""
from typing import Sequence, Tuple, Union

import numpy as np
import torch

#: A 1d array of (possibly time-dependent) coefficients.
Coefficients = Union[Sequence[float], np.ndarray]
#: A square operator.
Operator = Union[np.ndarray, torch.Tensor]
#: A quantum state (vector or density matrix).
State = Union[np.ndarray, torch.Tensor]
#: Nested-list Hamiltonian format: [[oper, coeffs, identifier?], ...].
Hamiltonian = Sequence[Sequence]
#: extend() mapping format: [(pulse, qubits, identifier_mapping?), ...].
PulseMapping = Sequence[Tuple]
#: Where computed values live.
Device = Union[str, torch.device]
