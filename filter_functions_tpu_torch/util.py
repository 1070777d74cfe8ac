"""Utilities of the PyTorch port (counterparts of
``filter_functions_tpu.util``).

Host metadata (operators, coefficients, identifiers) stays numpy, as in
the JAX package; the numerical helpers take tensors, or numpy arrays
where the JAX package took them.  The tensor-product family
(``tensor``, ``tensor_insert``, ``tensor_merge``, ``tensor_transpose``)
takes both: numpy in, numpy out; a tensor keeps its device and dtype.
"""
from __future__ import annotations

import functools
import inspect
import operator
import string
from itertools import zip_longest
from typing import (Callable, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from . import config, tracing

__all__ = ['paulis', 'abs2', 'all_array_equal', 'dot_HS',
           'get_sample_frequencies', 'hash_array_along_axis', 'mdot', 'adot',
           'matrix_power', 'geometric_series',
           'oper_equiv', 'remove_float_errors', 'tensor', 'tensor_insert',
           'tensor_merge', 'tensor_transpose', 'integrate',
           'cexp', 'cexpm1', 'CalculationError', 'parse_optional_parameters',
           'parse_operators', 'parse_spectrum', 'is_sequence_like',
           'get_indices_from_identifiers', 'progressbar',
           'progressbar_range']

#: The unnormalized Pauli matrices (I, X, Y, Z), host-side numpy.
paulis = np.array([
    [[1, 0], [0, 1]],
    [[0, 1], [1, 0]],
    [[0, -1j], [1j, 0]],
    [[1, 0], [0, -1]],
], dtype=complex)


class CalculationError(Exception):
    """A requested quantity was not computed and cannot be derived."""


def abs2(x):
    """|x|^2 of a tensor or numpy array."""
    is_complex = (x.is_complex() if isinstance(x, torch.Tensor)
                  else np.iscomplexobj(x))
    if is_complex:
        return x.real**2 + x.imag**2
    return x * x


def cexp(x) -> torch.Tensor:
    """e^{ix} of a real tensor (or array-like), complex128."""
    x = torch.as_tensor(x, dtype=config.REAL)
    return torch.complex(torch.cos(x), torch.sin(x))


def cexpm1(x) -> torch.Tensor:
    """e^{ix} - 1 = -2 sin^2(x/2) + i sin(x) of a real tensor, complex128;
    the half-angle form keeps full relative precision for small |x|."""
    x = torch.as_tensor(x, dtype=config.REAL)
    s = torch.sin(x / 2)
    return torch.complex(-2.0 * s * s, torch.sin(x))


def _host(x) -> np.ndarray:
    """numpy view of host metadata given as a tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -----------------------------------------------------------------------------
# Parameter parsing helpers
# -----------------------------------------------------------------------------
def parse_optional_parameters(**allowed: Sequence) -> Callable:
    """Decorator validating that selected keyword/positional arguments
    take one of a fixed set of values."""
    def decorator(func):
        sig = inspect.signature(func)
        names = list(sig.parameters)

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            for name, ok in allowed.items():
                pos = names.index(name)
                if pos < len(args):
                    val = args[pos]
                else:
                    val = kwargs.get(name, sig.parameters[name].default)
                if val not in ok:
                    raise ValueError(
                        f"Invalid value for {name}: {val}. "
                        f"Should be one of {tuple(ok)}.")
            return func(*args, **kwargs)
        return wrapper
    return decorator


def parse_operators(opers: Sequence, err_loc: str) -> np.ndarray:
    """Duck-type convert a sequence of operators to a host complex
    ndarray.

    Accepts tensors, numpy arrays, anything with ``full()``
    (qutip.Qobj), ``to_array()``, ``todense()``, or qopt-style ``.data``
    + ``.dexp``."""
    out = []
    for op in opers:
        if isinstance(op, (np.ndarray, torch.Tensor)):
            out.append(_host(op).squeeze())
        elif hasattr(op, 'full'):
            out.append(op.full())
        elif hasattr(op, 'to_array'):
            out.append(op.to_array())
        elif hasattr(op, 'todense'):
            out.append(op.todense())
        elif hasattr(op, 'data') and hasattr(op, 'dexp'):
            out.append(op.data)
        else:
            raise TypeError(f'Expected operators in {err_loc} to be NumPy '
                            'arrays or QuTiP Qobjs!')

    arr = np.asarray(out, dtype=complex)
    if arr.ndim > 3:
        raise ValueError(f'Expected operators in {err_loc} to be '
                         'two-dimensional!')
    if arr.shape[-1] != arr.shape[-2]:
        raise ValueError(f'Expected operators in {err_loc} to be square!')
    return arr


#: The error of a cross-spectrum that is not Hermitian.
NOT_HERMITIAN = 'Cross-spectra given but not Hermitian along first two axes'


def parse_spectrum(spectrum, omega, idx,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Validate and broadcast a power spectral density against
    (idx, omega).

    A tensor stays on its device and is checked there, shapes without a
    host round trip; anything else becomes a tensor on *device*
    (float64, or complex128 for complex input).  A 3-d spectrum must be
    Hermitian along its first two axes: checking that reads the device
    once (``sync.spectrum``).
    """
    spectrum = _broadcast_spectrum(spectrum, omega, idx, device)
    if spectrum.ndim == 3:
        hermitian = torch.allclose(spectrum, spectrum.conj().transpose(0, 1))
        tracing.counts['sync.spectrum'] += 1
        if not hermitian:
            raise ValueError(NOT_HERMITIAN)
    return spectrum


def _broadcast_spectrum(spectrum, omega, idx,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """:func:`parse_spectrum` without the Hermitian check of a 3-d
    spectrum, for a caller that checks it on a host copy it reads
    anyway."""
    if not isinstance(spectrum, torch.Tensor):
        spectrum = np.asarray(spectrum)
        spectrum = torch.as_tensor(
            spectrum, device=device,
            dtype=config.COMPLEX if np.iscomplexobj(spectrum)
            else config.REAL)
    elif not (spectrum.is_floating_point() or spectrum.is_complex()):
        spectrum = spectrum.to(config.REAL)
    shape = (len(idx),) * (spectrum.ndim - 1) + (omega.shape[-1],)
    try:
        spectrum = torch.broadcast_to(spectrum, shape)
    except RuntimeError as err:
        raise ValueError(f'Spectrum should be of shape {shape}, not '
                         f'{tuple(spectrum.shape)}.') from err
    if spectrum.ndim > 3:
        raise ValueError('Expected spectrum to have < 4 dimensions, not '
                         f'{spectrum.ndim}')
    return spectrum


def is_sequence_like(obj) -> bool:
    return hasattr(obj, '__len__') and hasattr(obj, '__getitem__')


def get_indices_from_identifiers(
        all_identifiers: Sequence[str],
        identifiers: Union[None, str, Sequence[str]]) -> np.ndarray:
    """Indices of *identifiers* within *all_identifiers*."""
    if identifiers is None:
        return np.arange(len(all_identifiers))
    table = {ident: i for i, ident in enumerate(all_identifiers)}
    if isinstance(identifiers, str):
        identifiers = [identifiers]
    try:
        return np.array([table[i] for i in identifiers])
    except KeyError:
        raise ValueError('Invalid identifiers given. All available ones '
                         f'are: {all_identifiers}')


# -----------------------------------------------------------------------------
# Tensor products
# -----------------------------------------------------------------------------
def _kron_shape(shape_a, shape_b, rank: int):
    """Output shape of a rank-*rank* tensor product with broadcasting of
    the leading axes."""
    lead = []
    for da, db in zip_longest(shape_a[-rank - 1::-1], shape_b[-rank - 1::-1],
                              fillvalue=1):
        if 1 in (da, db):
            lead.insert(0, max(da, db))
        elif da == db:
            lead.insert(0, da)
        else:
            raise ValueError(f'Incompatible shapes {shape_a} and {shape_b} '
                             f'for tensor product of rank {rank}.')
    prod = [da * db for da, db in zip_longest(shape_a[:-rank - 1:-1],
                                              shape_b[:-rank - 1:-1],
                                              fillvalue=1)][::-1]
    return tuple(lead) + tuple(prod)


def tensor(*args, rank: int = 2):
    """Tensor (Kronecker) product over the last *rank* axes with
    broadcasting over leading axes, evaluated as a balanced binary tree.
    Tensors give a tensor (numpy operands join the first tensor's
    device), numpy arrays a numpy array.

    >>> import numpy as np
    >>> Z = np.diag([1., -1.])
    >>> bool(np.array_equal(tensor(Z, Z), np.kron(Z, Z)))
    True
    """
    letters = string.ascii_letters
    sub_a, sub_b = letters[:rank], letters[rank:2 * rank]
    interleaved = ''.join(i + j for i, j in zip(sub_a, sub_b))
    subscripts = f'...{sub_a},...{sub_b}->...{interleaved}'
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  None)

    def lift(x):
        if device is None:
            x = np.asarray(x)
        else:
            x = torch.as_tensor(x, device=device)
        while x.ndim < rank:
            x = x[None]
        return x

    def pair(a, b):
        a, b = lift(a), lift(b)
        outshape = _kron_shape(a.shape, b.shape, rank)
        if device is None:
            out = np.einsum(subscripts, a, b)
        else:
            dtype = torch.promote_types(a.dtype, b.dtype)
            out = torch.einsum(subscripts, a.to(dtype), b.to(dtype))
        return out.reshape(outshape)

    items = list(args)
    while len(items) > 1:
        bit = len(items) % 2
        items = items[:bit] + [pair(items[i], items[i + 1])
                               for i in range(bit, len(items), 2)]
    return items[0]


def _einsum_any(subscripts: str, *ops):
    """einsum of numpy arrays, or of tensors where one operand is a
    tensor: the others join its device and the dtypes promote."""
    device = next((o.device for o in ops if isinstance(o, torch.Tensor)),
                  None)
    if device is None:
        return np.einsum(subscripts, *ops)
    ops = [torch.as_tensor(o, device=device) for o in ops]
    dtype = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(subscripts, *(o.to(dtype) for o in ops))


def _atleast_rank(x, rank: int):
    while x.ndim < rank:
        x = x[None]
    return x


def _check_dims(name: str, dims, rank: int) -> None:
    if len(dims) != rank:
        raise ValueError(f'{name}_dims should be of length rank = {rank}, '
                         f'not {len(dims)}')
    if len({len(d) for d in dims}) != 1:
        raise ValueError(f'Require all lists in {name}_dims to be of same '
                         'length!')


def _reshape(x, shape, name: str, rank: int):
    """*x* reshaped, or the error of a *name*_dims that does not fit."""
    try:
        return x.reshape(shape)
    except (ValueError, RuntimeError) as err:
        raise ValueError(f'{name}_dims not compatible with {name}.shape'
                         f'[-rank:] = {tuple(x.shape[-rank:])}') from err


def tensor_insert(arr, *args, pos, arr_dims, rank: int = 2):
    """Insert the factors *args* into the tensor-product chain *arr*,
    whose factors have the dimensions *arr_dims* (one list per axis of
    the product), at the positions *pos* (an int puts all of them
    there).  Tensors stay on their device; numpy operands join it.

    >>> import numpy as np
    >>> I, X, Y, Z = paulis
    >>> r = tensor_insert(tensor(X, I), Y, Z, pos=0,
    ...                   arr_dims=[[2, 2], [2, 2]])
    >>> bool(np.allclose(r, tensor(Y, Z, X, I)))
    True
    """
    if len(args) == 0:
        raise ValueError('Require nonzero number of args!')

    if np.issubdtype(type(pos), np.integer):
        pos = (int(pos),)
        if len(args) > 1:
            args = (tensor(*args, rank=rank),)
    elif len(pos) != len(args):
        raise ValueError('Expected pos to be either an int or a sequence of '
                         'the same length as the number of args, not length '
                         f'{len(pos)}')
    _check_dims('arr', arr_dims, rank)

    def insert_one(target, ins, dims, p):
        nfac = len(dims[0])
        ins_chars = string.ascii_letters[:rank]
        arr_chars = string.ascii_letters[rank:(nfac + 1) * rank]
        out = arr_chars[:p] + ''.join(
            ins_chars[r] + arr_chars[p + r * nfac:p + (r + 1) * nfac]
            for r in range(rank))
        subscripts = f'...{ins_chars},...{arr_chars}->...{out}'
        outshape = _kron_shape(ins.shape, target.shape, rank)
        flat = [d for axis in dims for d in axis]
        reshaped = target.reshape(*target.shape[:-rank], *flat)
        return _einsum_any(subscripts, ins, reshaped).reshape(outshape)

    result = arr
    dims = [list(axis) for axis in arr_dims]
    nfac = len(dims[0])
    divs, mods = zip(*[divmod(p, nfac) if p != nfac else (0, p)
                       for p in pos])
    for shift, i in enumerate(sorted(range(len(args)),
                                     key=lambda i: mods[i])):
        if divs[i] not in (-1, 0):
            raise IndexError(f'Invalid position {pos[i]} specified. Must be '
                             f'between -{nfac} and {nfac}.')
        p = mods[i] + shift
        try:
            result = insert_one(result, _atleast_rank(args[i], rank), dims, p)
        except (ValueError, RuntimeError) as err:
            raise ValueError(
                f'Could not insert arg {i} with shape {tuple(result.shape)} '
                f'into the array with shape {tuple(args[i].shape)} at '
                f'position {mods[i]}.') from err
        for axis, d in zip(dims, args[i].shape[-rank:]):
            axis.insert(p, d)
    return result


def tensor_merge(arr, ins, pos, arr_dims, ins_dims, rank: int = 2):
    """Merge the tensor-product chain *ins* (factor dimensions
    *ins_dims*) into the chain *arr* (*arr_dims*), factor i of *ins*
    before factor ``pos[i]`` of *arr*.  Tensors stay on their device;
    numpy operands join it.

    >>> import numpy as np
    >>> I, X, Y, Z = paulis
    >>> r = tensor_merge(tensor(X, Y, Z), tensor(I, I), pos=[1, 2],
    ...                  arr_dims=[[2]*3, [2]*3], ins_dims=[[2]*2, [2]*2])
    >>> bool(np.allclose(r, tensor(X, I, Y, I, Z)))
    True
    """
    for name, dims in (('arr', arr_dims), ('ins', ins_dims)):
        _check_dims(name, dims, rank)

    n_ins = len(ins_dims[0])
    n_arr = len(arr_dims[0])
    ins_chars = string.ascii_letters[:n_ins * rank]
    arr_chars = string.ascii_letters[n_ins * rank:(n_ins + n_arr) * rank]
    out_chars = ''
    for r in range(rank):
        arr_part = arr_chars[r * n_arr:(r + 1) * n_arr]
        ins_part = ins_chars[r * n_ins:(r + 1) * n_ins]
        for i, (p, ch) in enumerate(sorted(zip(pos, ins_part))):
            if p != n_arr:
                div, p = divmod(p, n_arr)
                if div not in (-1, 0):
                    raise IndexError(f'Invalid position {pos[i]} specified. '
                                     f'Must be between -{n_arr} and {n_arr}.')
            arr_part = arr_part[:p + i] + ch + arr_part[p + i:]
        out_chars += arr_part

    subscripts = f'...{ins_chars},...{arr_chars}->...{out_chars}'
    outshape = _kron_shape(ins.shape, arr.shape, rank)
    ins_r = _reshape(ins, (*ins.shape[:-rank],
                           *[d for axis in ins_dims for d in axis]),
                     'ins', rank)
    arr_r = _reshape(arr, (*arr.shape[:-rank],
                           *[d for axis in arr_dims for d in axis]),
                     'arr', rank)
    return _einsum_any(subscripts, ins_r, arr_r).reshape(outshape)


def tensor_transpose(arr, order: Sequence[int], arr_dims, rank: int = 2):
    """Permute the factors of the tensor-product chain *arr* (factor
    dimensions *arr_dims*) into *order*.  A tensor stays on its device.

    >>> import numpy as np
    >>> I, X, Y, Z = paulis
    >>> r = tensor_transpose(tensor(X, Y, Z), [1, 2, 0],
    ...                      arr_dims=[[2, 2, 2]]*2)
    >>> bool(np.allclose(r, tensor(Y, Z, X)))
    True
    """
    _check_dims('arr', arr_dims, rank)
    nfac = len(arr_dims[0])
    order = list(order)
    if sorted(order) != list(range(nfac)):
        if any(not np.issubdtype(type(o), np.integer) for o in order):
            raise TypeError("Could not transpose the order. Are all elements "
                            "of 'order' integers?")
        raise ValueError("Could not transpose the order. Are all elements of "
                         "'order' unique and match the array?")
    n_lead = arr.ndim - rank
    axes = (list(range(n_lead))
            + [n_lead + r * nfac + o for r in range(rank) for o in order])
    reshaped = _reshape(arr, (*arr.shape[:-rank],
                              *[d for axis in arr_dims for d in axis]),
                        'arr', rank)
    transposed = (reshaped.permute(axes) if isinstance(reshaped, torch.Tensor)
                  else reshaped.transpose(axes))
    return transposed.reshape(arr.shape)


# -----------------------------------------------------------------------------
# Matrix products
# -----------------------------------------------------------------------------
def mdot(arr, axis: int = 0):
    """Reduce a stack of matrices by matrix product along *axis*:
    ``mdot([A0, A1, A2]) = A0 @ A1 @ A2``."""
    if isinstance(arr, torch.Tensor):
        mats = arr.transpose(0, axis)
    else:
        mats = np.swapaxes(np.asarray(arr), 0, axis)
    return functools.reduce(operator.matmul, mats)


def adot(arr: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Accumulated matrix product along *axis*:
    ``out[g] = arr[g] @ arr[g-1] @ ... @ arr[0]``.

    A doubling scan, ``out[g] <- out[g] @ out[g - s]`` for s = 1, 2, 4,
    ...: log2 G batched products in place of G small ones, each a launch
    of its own.
    """
    out, shift = arr.movedim(axis, 0), 1
    while shift < out.shape[0]:
        out = torch.cat([out[:shift], out[shift:] @ out[:-shift]])
        shift *= 2
    return out.movedim(0, axis)


def matrix_power(a: torch.Tensor, p: int) -> torch.Tensor:
    """Square matrices *a* (..., n, n) raised to the integer power
    *p* >= 0 by binary exponentiation."""
    result = torch.eye(a.shape[-1], dtype=a.dtype,
                       device=a.device).expand_as(a)
    base, k = a, int(p)
    while k > 0:
        if k & 1:
            result = result @ base
        k >>= 1
        if k:
            base = base @ base
    return result


def geometric_series(t: torch.Tensor, repeats: int) -> torch.Tensor:
    r"""The matrix geometric series :math:`\sum_{g=0}^{G-1} T^g` of
    square matrices *t* (..., n, n) by binary doubling,
    ``S_{2k} = S_k + T^k S_k`` and ``T^{2k} = T^k T^k``: about
    2 log2 G batched products, no solve and no invertibility check."""
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device).expand_as(t)
    s, tk, k = eye, t, int(repeats)
    result, power = torch.zeros_like(t), eye       # sum so far, T^(done)
    while k > 0:
        if k & 1:
            result = result + power @ s
            power = power @ tk
        k >>= 1
        if k:
            s = s + tk @ s
            tk = tk @ tk
    return result


def integrate(f: torch.Tensor, x: Optional[torch.Tensor] = None,
              dx: float = 1.0) -> torch.Tensor:
    """Trapezoidal integral of *f* over its last axis, at sample points
    *x* or with spacing *dx*."""
    d = torch.diff(x) if x is not None else dx
    return ((f[..., 1:] + f[..., :-1]) * d).sum(-1) / 2


# -----------------------------------------------------------------------------
# Misc numerics
# -----------------------------------------------------------------------------
def remove_float_errors(arr, eps_scale: Optional[float] = None):
    """Zero out entries below dtype-eps * scale (default scale: the
    size of the last axis).  numpy arrays are changed in place, tensors
    are returned anew."""
    if isinstance(arr, torch.Tensor):
        scale = (arr.shape[-1] if arr.ndim else 1) if eps_scale is None \
            else eps_scale
        atol = torch.finfo(arr.real.dtype).eps * scale

        def clip(x):
            return torch.where(x.abs() <= atol, 0.0, x)
        if arr.is_complex():
            return torch.complex(clip(arr.real), clip(arr.imag))
        return clip(arr)
    arr = np.array(arr) if not isinstance(arr, np.ndarray) else arr
    if eps_scale is None:
        atol = np.finfo(arr.dtype).eps * (arr.shape[-1] if arr.ndim else 1)
    else:
        atol = np.finfo(arr.dtype).eps * eps_scale
    if np.iscomplexobj(arr):
        arr.real[np.abs(arr.real) <= atol] = 0
        arr.imag[np.abs(arr.imag) <= atol] = 0
    else:
        arr[np.abs(arr) <= atol] = 0
    return arr


def dot_HS(U, V, eps: Optional[float] = None):
    r"""Hilbert-Schmidt inner product tr(U^dag V) of host operators
    (tensors are read to the host)."""
    U = U.full() if hasattr(U, 'full') else U
    V = V.full() if hasattr(V, 'full') else V
    U, V = _host(U), _host(V)
    if eps is None:
        try:
            eps = max(np.finfo(U.dtype).eps, np.finfo(V.dtype).eps) \
                * np.prod(U.shape) * V.shape[-1] * 2
        except ValueError:
            eps = 0
    res = np.einsum('...ij,...ij', U.conj(), V)
    if eps > 0:
        res = np.around(res, decimals=abs(int(np.log10(eps))))
    return res if np.iscomplexobj(res) and res.imag.any() else res.real


def oper_equiv(psi, phi, eps: Optional[float] = None,
               normalized: bool = False) -> Tuple[bool, float]:
    """Check equality up to global phase; returns (equal, phase)."""
    psi = psi.full() if hasattr(psi, 'full') else psi
    phi = phi.full() if hasattr(phi, 'full') else phi
    psi, phi = np.atleast_2d(_host(psi), _host(phi))
    if eps is None:
        eps = (max(np.finfo(psi.dtype).eps, np.finfo(phi.dtype).eps)
               * np.prod(psi.shape) * phi.shape[-1] * 2)
        if not normalized:
            eps *= (np.prod(psi.shape[-2:]) * phi.shape[-1] * 2)**2
    try:
        inner = dot_HS(psi, phi, eps=0)
    except ValueError as err:
        raise ValueError('psi and phi have incompatible dimensions!') from err
    norm = 1 if normalized else np.sqrt(
        dot_HS(psi, psi, eps=0) * dot_HS(phi, phi, eps=0))
    return abs(norm - abs(inner)) <= eps, np.angle(inner)


@parse_optional_parameters(spacing=('log', 'linear'))
def get_sample_frequencies(pulse, n_samples: int = 300, spacing: str = 'log',
                           include_quasistatic: bool = False,
                           omega_min: Optional[float] = None,
                           omega_max: Optional[float] = None) -> np.ndarray:
    r"""Default angular-frequency grid (host numpy) for a pulse: IR
    cutoff 2pi*1e-2/tau, UV cutoff 2pi*10/min(dt)."""
    xspace = np.geomspace if spacing == 'log' else np.linspace
    tau = float(pulse.tau)
    dt_min = float(np.min(np.asarray(pulse.dt)))
    omega_min = 2 * np.pi * 1e-2 / tau if omega_min is None else omega_min
    omega_max = 2 * np.pi * 1e+1 / dt_min if omega_max is None else omega_max
    omega = xspace(omega_min, omega_max, n_samples - include_quasistatic)
    if include_quasistatic:
        return np.insert(omega, 0, 0)
    return omega


def hash_array_along_axis(arr, axis: int = 0) -> List[int]:
    """Hashes of subarrays along *axis* (adding 0.0 sanitizes -0.0)."""
    arr = _host(arr)
    return [hash((sub + 0.0).tobytes())
            for sub in np.swapaxes(arr, 0, axis)]


def all_array_equal(it: Iterable) -> bool:
    """True if all (host) arrays in *it* are byte-identical.

    Deduplicates by object identity first: pulse trains built as
    ``[p] * G`` hand the same array object G times.
    """
    seen_ids: set = set()
    keepalive = []  # pin yielded objects so ids can't be recycled
    hashes: set = set()
    for i in it:
        if id(i) in seen_ids:
            continue
        seen_ids.add(id(i))
        keepalive.append(i)
        hashes.add(hash(_host(i).tobytes()))
        if len(hashes) > 1:
            return False
    return len(hashes) == 1


def progressbar(iterable, *args, **kwargs):
    """tqdm wrapper where tqdm is installed; the iterable otherwise."""
    try:
        from tqdm.autonotebook import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, *args, **kwargs)


def progressbar_range(*args, show_progressbar: bool = False, **kwargs):
    if show_progressbar:
        return progressbar(range(*args), **kwargs)
    return range(*args)
