r"""The weighted K2 lattice of the second-order frequency shifts from the
separable tables, in two CUDA launches and one cuBLAS product.

:func:`.numeric._factored_weighted_lattice` hands each chunk of segments
here on CUDA tensors.  ``csrc/k2_tables.cu`` builds every entry of the
tables of :func:`.numeric._second_order_factored_single` in registers and
writes only what the product reads: the left tables' 8 terms as float64
planes (real part, imaginary part) and the right tables' 8 terms times
each row of the weights, both K-major with K = (term, frequency).  One
batched DGEMM reduces over K for all rows at once, and an epilogue adds
the general form's f_z term and writes ell as complex128.  The plain
version, the composite of :mod:`.numeric`, runs on the CPU and in the
backward.

* :func:`check` -- what the route takes: raises on a wrong dtype, shape
  or device mix.
* :func:`weighted_lattice` -- the route (CUDA tensors only).
* :func:`tables` -- its first launch alone.
* :data:`launches` -- how many times the tables kernel was launched (one
  a call of :func:`weighted_lattice`; its epilogue is not counted).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

#: Number of launches of the tables kernel by :func:`weighted_lattice`.
launches = 0

#: Terms of the separable tables: f_x (general form), the y = 0 limit and
#: the six of the divided-difference series; the kernel's kT.
TERMS = 8
#: Coefficients of D_k the kernel takes, k = 1.._K (_SO_SMALL_K).
_K = 6

@functools.cache
def _coefficients(device: torch.device) -> torch.Tensor:
    """The static coefficients of :func:`.numeric._frac_divdiff_static`
    (series and closed form, k = 1..6) as one (2, 6, 13, 13, 2) float64
    tensor on *device*, uploaded once per device."""
    from .. import numeric
    m, b, _, _ = numeric._frac_divdiff_static(_K)
    return torch.view_as_real(torch.stack(
        [torch.from_numpy(m), torch.from_numpy(b)])).to(device).contiguous()


def check(omega: torch.Tensor, eigvals: torch.Tensor, dt: torch.Tensor,
          weights: torch.Tensor) -> None:
    """Checks the arguments of :func:`weighted_lattice`: omega (n_w,),
    eigvals (..., d), dt of eigvals' leading shape, weights (n_s, n_w),
    all float64 and on one device."""
    tensors = (omega, eigvals, dt, weights)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError('the K2 tables take tensors')
    if any(t.dtype != torch.float64 for t in tensors):
        raise TypeError(f'the K2 tables take float64 frequencies, '
                        f'eigenvalues, durations and weights, got '
                        f'{[str(t.dtype) for t in tensors]}')
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'the K2 tables\' arguments lie on several '
                         f'devices: {devices}')
    if omega.dim() != 1 or weights.dim() != 2 or eigvals.dim() < 1 or \
            weights.shape[1] != omega.shape[0] or \
            dt.shape != eigvals.shape[:-1]:
        raise ValueError(f'the K2 tables take omega (n_w,), eigvals (..., d), '
                         f'dt (...) and weights (n_s, n_w); got '
                         f'{tuple(omega.shape)}, {tuple(eigvals.shape)}, '
                         f'{tuple(dt.shape)}, {tuple(weights.shape)}')


def weighted_lattice(omega: torch.Tensor, eigvals: torch.Tensor,
                     dt: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """ell[..., s, ij, mn] = sum_w weights[s, w] I[..., w, ij, mn], the K2
    lattice I of segments *eigvals* (..., d), *dt* (...) reduced over
    the frequencies *omega* (n_w,) by each row of *weights* (n_s, n_w):
    complex128 (..., n_s, d^2, d^2), as
    :func:`.numeric._factored_weighted_lattice_plain`.

    Two launches of ``csrc/k2_tables.cu`` and one ``torch.bmm``: the
    tables kernel (:func:`tables`) writes left (segments, 2 d^2, 8 n_w)
    and right (segments, n_s d^2, 8 n_w); the product left @ right^T
    reads both as they lie (right^T is a transposed view, which cuBLAS
    takes as its op); the epilogue writes ell.  Arguments as
    :func:`check` takes them, on a CUDA device."""
    check(omega, eigvals, dt, weights)
    lead = eigvals.shape[:-1]
    d = eigvals.shape[-1]
    ev = eigvals.reshape(-1, d).contiguous()
    seg_dt = dt.reshape(-1).contiguous()
    left, right, rho = tables(omega, ev, seg_dt, weights)
    prod = torch.bmm(left, right.mT)               # (n_seg, 2 d^2, n_s d^2)
    del left, right
    n_seg, n_s = ev.shape[0], weights.shape[0]
    ell = torch.empty(n_seg, n_s, d * d, d * d, dtype=torch.complex128,
                      device=ev.device)
    _, epilogue, _ = _launchers()
    with torch.cuda.device(ev.device):
        err = epilogue(prod.data_ptr(), rho.data_ptr(), ev.data_ptr(),
                       seg_dt.data_ptr(), ell.data_ptr(), n_seg, d,
                       omega.shape[0], n_s,
                       torch.cuda.current_stream(ev.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'k2_tables epilogue launch failed with CUDA '
                           f'error {err}')
    return ell.reshape(*lead, n_s, d * d, d * d)


def tables(omega: torch.Tensor, eigvals: torch.Tensor, dt: torch.Tensor,
           weights: torch.Tensor):
    """The tables kernel alone, one launch: (left (n_seg, 2 d^2, 8 n_w),
    right (n_seg, n_s d^2, 8 n_w), the partial sums of rho (n_seg,
    ceil(n_w / 32), n_s, d^2)), float64, of segments *eigvals* (n_seg, d)
    and *dt* (n_seg,), contiguous CUDA tensors."""
    global launches
    device = eigvals.device
    if device.type != 'cuda':
        raise ValueError(f'the K2 tables kernel runs on CUDA tensors; got '
                         f'{device}')
    n_seg, d = eigvals.shape
    d2 = d * d
    n_w, n_s = omega.shape[0], weights.shape[0]
    omega, weights = omega.contiguous(), weights.contiguous()
    launch, _, tile_o = _launchers()
    f64 = dict(dtype=torch.float64, device=device)
    left = torch.empty(n_seg, 2 * d2, TERMS * n_w, **f64)
    right = torch.empty(n_seg, n_s * d2, TERMS * n_w, **f64)
    rho = torch.empty(n_seg, -(-n_w // tile_o), n_s, d2, **f64)
    with torch.cuda.device(device):
        err = launch(omega.data_ptr(), eigvals.data_ptr(), dt.data_ptr(),
                     weights.data_ptr(), _coefficients(device).data_ptr(),
                     left.data_ptr(), right.data_ptr(), rho.data_ptr(),
                     n_seg, d, n_w, n_s,
                     torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'k2_tables kernel launch failed with CUDA '
                           f'error {err}')
    launches += 1
    return left, right, rho


@functools.cache
def _launchers() -> Tuple[ctypes._CFuncPtr, ctypes._CFuncPtr, int]:
    """The two launch functions of ``csrc/k2_tables.cu`` and its tile of
    frequencies (the rho partials per segment and row)."""
    lib = _build.load('k2_tables')
    tables = lib.k2_tables_launch
    tables.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    tables.restype = ctypes.c_int
    epilogue = lib.k2_epilogue_launch
    epilogue.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    epilogue.restype = ctypes.c_int
    tile_o = lib.k2_tables_tile_o
    tile_o.restype = ctypes.c_int
    return tables, epilogue, tile_o()
