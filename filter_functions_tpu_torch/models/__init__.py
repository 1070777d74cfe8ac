"""Ready-made pulses of the PyTorch port."""
from .qft import qft_pulse_arrays, qft_pulse_sequence

__all__ = ['qft_pulse_arrays', 'qft_pulse_sequence']
