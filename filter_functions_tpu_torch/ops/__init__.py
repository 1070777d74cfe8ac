"""The factored Ozaki contraction and its CUDA kernels, and the kernel of
the second-order shifts' separable K2 tables."""
from . import dword, k2_tables, ozaki, products

__all__ = ['dword', 'k2_tables', 'ozaki', 'products']
