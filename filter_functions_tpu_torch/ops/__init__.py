"""The factored Ozaki contraction and its CUDA kernel."""
from . import dword, ozaki

__all__ = ['dword', 'ozaki']
