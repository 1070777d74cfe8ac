"""The factored Ozaki contraction and its CUDA kernels."""
from . import dword, ozaki, products

__all__ = ['dword', 'ozaki', 'products']
