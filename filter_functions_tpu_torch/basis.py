"""Operator bases of the PyTorch port (counterpart of
``filter_functions_tpu.basis``).

A :class:`Basis` holds a read-only host numpy master copy; its
characteristics (hermiticity, orthonormality, ...) are computed there
and cached, for dispatch decisions only.  :meth:`Basis.tensor` gives a
complex128 copy on a device, cached per device.

The Pauli structure constants (:meth:`Basis.pauli_mult_table`) and the
index maps of :func:`equivalent_pauli_basis_elements` and
:func:`remap_pauli_basis_elements` are exact host-side integer
arithmetic; ``extend`` and ``remap`` index device tensors with them.
"""
from __future__ import annotations

import functools
from itertools import product as iproduct
from typing import Dict, Optional, Sequence, Tuple, Union
from warnings import warn

import numpy as np
import torch

from . import config, util

__all__ = ['Basis', 'expand', 'ggm_expand', 'normalize',
           'equivalent_pauli_basis_elements', 'remap_pauli_basis_elements']


def _frobenius_norm(arr: np.ndarray) -> np.ndarray:
    return np.linalg.norm(arr, axis=(-1, -2))[..., None, None]


def normalize(b: Union[np.ndarray, 'Basis']) -> 'Basis':
    """Return a copy normalized w.r.t. the Frobenius norm."""
    arr = np.asarray(b.np if isinstance(b, Basis) else b)
    return Basis(arr / _frobenius_norm(arr),
                 btype=b.btype if isinstance(b, Basis) else None,
                 labels=b.labels if isinstance(b, Basis) else None,
                 skip_checks=True)


class Basis:
    """An operator basis: ``n <= d**2`` matrices of shape ``(d, d)``.

    Parameters
    ----------
    basis_array :
        Sequence of square matrices (tensors, numpy arrays, qutip
        objects, duck-typed).
    traceless :
        If True, insist the elements are traceless (identity allowed).
    btype :
        'Pauli', 'GGM', 'Custom', or 'From partial'.
    labels :
        Per-element display labels.
    """

    def __init__(self, basis_array, traceless: Optional[bool] = None,
                 btype: Optional[str] = None,
                 labels: Optional[Sequence[str]] = None,
                 skip_checks: bool = False):
        if isinstance(basis_array, Basis):
            arr = basis_array.np.copy()
            btype = btype or basis_array.btype
            labels = labels if labels is not None else basis_array.labels
        else:
            if not util.is_sequence_like(basis_array):
                raise TypeError('Invalid data type. Must be array_like')
            if hasattr(basis_array, 'shape') and len(basis_array.shape) == 2:
                basis_array = [basis_array]
            arr = util.parse_operators(basis_array, 'basis_array')
            if arr.ndim == 2:
                arr = arr[None]

        if arr.shape[0] > arr.shape[-1] * arr.shape[-2]:
            raise ValueError('Given overcomplete set of basis matrices. '
                             'Not linearly independent.')
        if not skip_checks and traceless:
            # traceless (identity exempt) demanded explicitly
            probe = Basis(arr, skip_checks=True)
            if not probe.istraceless:
                raise ValueError('The basis elements are not traceless (up '
                                 'to an identity element) but a traceless '
                                 'basis was requested!')

        self.btype = btype or 'Custom'
        self.d = int(arr.shape[-1])
        if labels is not None and len(labels) != len(arr):
            raise ValueError(f'Got {len(labels)} basis labels but expected '
                             f'{len(arr)}')
        self.labels = (list(labels) if labels is not None
                       else [f'$C_{{{i}}}$' for i in range(len(arr))])
        self._set(np.ascontiguousarray(arr, dtype=complex))

    def _set(self, arr: np.ndarray) -> None:
        """Install a new master copy and drop everything derived from
        the old one."""
        self._np = arr
        self._np.setflags(write=False)
        self._dev: Dict[torch.device, torch.Tensor] = {}
        self._cache: dict = {}

    # -- array-ish interface -------------------------------------------------
    @property
    def np(self) -> np.ndarray:
        """Host numpy complex master copy (read-only)."""
        return self._np

    def tensor(self, device: Union[str, torch.device]) -> torch.Tensor:
        """complex128 copy of the basis on *device* (cached)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = torch.tensor(self._np, dtype=config.COMPLEX,
                                             device=device)
        return self._dev[device]

    def __array__(self, dtype=None, copy=None):
        return np.array(self._np, dtype=dtype or complex)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._np.shape

    @property
    def ndim(self) -> int:
        return self._np.ndim

    def __len__(self) -> int:
        return self._np.shape[0]

    def __getitem__(self, key):
        return self._np[key]

    def __iter__(self):
        return iter(self._np)

    def __repr__(self):
        return f'Basis(btype={self.btype!r}, n={len(self)}, d={self.d})'

    @property
    def _atol(self) -> float:
        return np.finfo(complex).eps * self.d**3

    def __eq__(self, other) -> bool:
        if isinstance(other, Basis):
            other = other.np
        try:
            other = util._host(other)
        except Exception:
            return NotImplemented
        if self.shape != other.shape:
            return False
        return np.allclose(self._np, other, atol=self._atol, rtol=0)

    def __hash__(self):
        return hash((self.btype, self.shape, self._np.tobytes()))

    def __contains__(self, item) -> bool:
        item = util._host(item)
        return any(np.allclose(item, el, atol=self._atol, rtol=0)
                   for el in self._np)

    @property
    def T(self) -> 'Basis':
        return Basis(self._np.swapaxes(-1, -2), btype=self.btype,
                     labels=self.labels, skip_checks=True)

    @property
    def H(self) -> 'Basis':
        return Basis(self._np.conj().swapaxes(-1, -2), btype=self.btype,
                     labels=self.labels, skip_checks=True)

    # -- characteristics (host-side, cached) ----------------------------------
    def _cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @property
    def isherm(self) -> bool:
        return self._cached('isherm', lambda: bool(np.allclose(
            self._np, self._np.conj().swapaxes(-1, -2),
            atol=self._atol, rtol=0)))

    @property
    def isnorm(self) -> bool:
        return self._cached('isnorm', lambda: bool(np.allclose(
            _frobenius_norm(self._np).ravel(), 1, atol=self._atol, rtol=0)))

    @property
    def isorthogonal(self) -> bool:
        def check():
            if self._np.ndim == 2 or len(self) == 1:
                return True
            u = self._np.reshape(len(self), -1)
            gram = u.conj() @ u.T
            off = gram[~np.eye(len(self), dtype=bool)]
            return bool(np.allclose(off, 0,
                                    atol=np.finfo(complex).eps * self.d**6,
                                    rtol=0))
        return self._cached('isorthogonal', check)

    @property
    def isorthonorm(self) -> bool:
        return self.isorthogonal and self.isnorm

    @property
    def istraceless(self) -> bool:
        def check():
            tr = util.remove_float_errors(np.einsum('...jj', self._np),
                                          self.d**2)
            nz = np.atleast_1d(tr).nonzero()[0]
            if nz.size == 0:
                return True
            if nz.size > 1:
                return False
            # Exactly one traceful element: allowed iff it is ~identity.
            el = self._np[nz[0]] if self._np.ndim == 3 else self._np
            diag_equal = np.allclose(np.diag(el), el[0, 0],
                                     atol=self._atol, rtol=0)
            offdiag_zero = np.allclose(
                el[~np.eye(self.d, dtype=bool)], 0, atol=self._atol, rtol=0)
            return bool(diag_equal and offdiag_zero)
        return self._cached('istraceless', check)

    @property
    def iscomplete(self) -> bool:
        return self._cached('iscomplete', lambda: bool(
            np.linalg.matrix_rank(self._np.reshape(len(self), -1))
            == self.d**2))

    @property
    def sparse(self) -> np.ndarray:
        """The dense host array, as the JAX package's ``Basis.sparse``
        returns it (the reference's COO property): no contraction here
        takes a sparse format."""
        return self._np

    # -- trace tensor ------------------------------------------------------------
    @property
    def four_element_traces(self) -> np.ndarray:
        r"""Dense host trace tensor T_ijkl = tr(C_i C_j C_k C_l), cached.

        Only materialized for n <= 64; larger bases contract through
        the basis instead (:func:`.numeric._trace_contract_basis`).
        """
        def compute():
            n = len(self)
            if n > 64:
                raise MemoryError(
                    'Dense four_element_traces too large for n = '
                    f'{n}; use the contraction kernels instead.')
            b = self._np
            return np.einsum('iab,jbc,kcd,lda->ijkl', b, b, b, b,
                             optimize=True)
        return self._cached('four_element_traces', compute)

    def pauli_mult_table(self) -> Tuple[np.ndarray, np.ndarray]:
        """Structure constants of a normalized n-qubit Pauli basis:
        ``(index, phase)`` with ``C_a C_b = phase[a, b] / sqrt(d)
        C_{index[a, b]}``, int64 and unit-modulus complex128 host
        arrays."""
        if self.btype != 'Pauli':
            raise ValueError('Structure-constant table only available for '
                             'Pauli bases')
        return _pauli_mult_table(int(round(np.log2(self.d))))

    # -- expansion -------------------------------------------------------------
    def expand(self, M, hermitian: bool = False, traceless: bool = False,
               tidyup: bool = False):
        """Expansion coefficients of matrices *M* in this basis."""
        if self.btype == 'GGM' and self.iscomplete:
            return ggm_expand(M, traceless, hermitian, tidyup)
        return expand(M, self, self.isnorm, hermitian, tidyup)

    def normalize(self, copy: bool = False):
        if copy:
            return normalize(self)
        self._set(self._np / _frobenius_norm(self._np))

    def tidyup(self, eps_scale: Optional[float] = None) -> None:
        atol = self._atol if eps_scale is None else (
            np.finfo(complex).eps * eps_scale)
        arr = self._np.copy()
        arr.real[np.abs(arr.real) <= atol] = 0
        arr.imag[np.abs(arr.imag) <= atol] = 0
        self._set(arr)

    # -- constructors ------------------------------------------------------------
    @classmethod
    def pauli(cls, n: int) -> 'Basis':
        r"""Normalized n-qubit Pauli basis {I, X, Y, Z}^{\otimes n}."""
        d = 2**n
        # element (d_0 ... d_{n-1}) = P_{d_0} x ... x P_{d_{n-1}}, the
        # first digit most significant; one outer product per qubit
        elems = np.ones((1, 1, 1), dtype=complex)
        for k in range(n):
            elems = np.einsum('aij,bkl->abikjl', elems, util.paulis).reshape(
                4**(k + 1), 2**(k + 1), 2**(k + 1))
        elems = elems / np.sqrt(d)
        labels = [''.join('IXYZ'[dig] for dig in digits)
                  for digits in iproduct(range(4), repeat=n)]
        return cls(elems, btype='Pauli', labels=labels, skip_checks=True)

    @classmethod
    def ggm(cls, d: int) -> 'Basis':
        r"""Normalized generalized Gell-Mann basis in d dimensions.

        Element order: identity, then the d(d-1)/2 symmetric
        off-diagonal elements (row-major upper triangle), then the
        antisymmetric ones in the same order, then the d-1 diagonal
        elements.
        """
        lam = np.zeros((d * d, d, d), dtype=complex)
        lam[0] = np.eye(d) / np.sqrt(d)
        n_sym = d * (d - 1) // 2
        rows, cols = np.triu_indices(d, k=1)
        inv_sqrt2 = 1 / np.sqrt(2)
        for i, (j, k) in enumerate(zip(rows, cols)):
            lam[1 + i, j, k] = inv_sqrt2
            lam[1 + i, k, j] = inv_sqrt2
            lam[1 + n_sym + i, j, k] = -1j * inv_sqrt2
            lam[1 + n_sym + i, k, j] = 1j * inv_sqrt2
        for el in range(1, d):
            norm = np.sqrt(el * (el + 1))
            lam[2 * n_sym + el, range(el), range(el)] = 1 / norm
            lam[2 * n_sym + el, el, el] = -el / norm
        return cls(lam, btype='GGM',
                   labels=[rf'$\Lambda_{{{i}}}$' for i in range(d * d)],
                   skip_checks=True)

    @classmethod
    def from_partial(cls, partial_basis_array,
                     traceless: Optional[bool] = None,
                     btype: Optional[str] = None,
                     labels: Optional[Sequence[str]] = None) -> 'Basis':
        """Complete a partial orthonormal set to a full basis via the
        nullspace of its GGM expansion coefficients."""
        if btype is None:
            btype = 'From partial'
        if labels is None and isinstance(partial_basis_array, Basis):
            if len(partial_basis_array.labels) == len(partial_basis_array):
                labels = partial_basis_array.labels
        elems = Basis(partial_basis_array, skip_checks=True)
        elems.normalize()
        if not elems.isherm:
            warn("(Some) elems not hermitian! The resulting basis also "
                 "won't be.")
        if not elems.isorthogonal:
            raise ValueError("The basis elements are not orthogonal!")
        if traceless is None:
            traceless = elems.istraceless
        elif traceless and not elems.istraceless:
            raise ValueError("The basis elements are not traceless (up to "
                             "an identity element) but a traceless basis "
                             "was requested!")
        if labels is not None and len(labels) not in (len(elems),
                                                      elems.d**2):
            raise ValueError(f'Got {len(labels)} labels but expected '
                             f'{len(elems)} or {elems.d**2}')

        ggm = cls.ggm(elems.d)
        coeffs = np.asarray(ggm.expand(elems.np, traceless=traceless,
                                       hermitian=elems.isherm, tidyup=True))
        ggm_arr = ggm.np
        if traceless:
            id_el, ggm_arr = ggm_arr[:1], ggm_arr[1:]
            coeffs = coeffs[..., 1:]
        coeffs = coeffs[(coeffs != 0).any(axis=-1)]
        if coeffs.size != 0:
            null = _null_space(coeffs)
            coeffs = np.concatenate((coeffs, null.T))
            arr = np.einsum('ij,jkl->ikl', coeffs, ggm_arr)
        else:
            arr = ggm_arr
        if traceless:
            arr = np.concatenate((id_el, arr))

        out = cls(arr, btype=btype, skip_checks=True)
        out.tidyup()
        if labels is not None and len(labels) == len(elems):
            labels = list(labels)
            if traceless:
                idmat = np.eye(elems.d) / np.sqrt(elems.d)
                id_idx = next((i for i, el in enumerate(elems.np)
                               if np.allclose(idmat, el, rtol=0,
                                              atol=elems._atol)), 0)
                labels.insert(0, labels.pop(id_idx))
            labels.extend(f'$C_{{{i}}}$'
                          for i in range(len(labels), len(out)))
            out.labels = labels
        elif labels is not None:
            out.labels = list(labels)
        return out


def _null_space(a: np.ndarray) -> np.ndarray:
    """Orthonormal nullspace basis via SVD."""
    u, s, vh = np.linalg.svd(a, full_matrices=True)
    m, n = a.shape
    rcond = np.finfo(s.dtype).eps * max(m, n)
    tol = np.amax(s, initial=0.) * rcond
    num = np.sum(s > tol, dtype=int)
    return vh[num:].conj().T


def expand(M, basis, normalized: bool = True, hermitian: bool = False,
           tidyup: bool = False):
    r"""Expansion coefficients c_j = tr(M C_j) [/ tr(C_j^dag C_j)].

    A tensor *M* gives a tensor on its device (real for a hermitian
    basis and ``hermitian=True``); numpy input gives numpy.
    """
    b = basis.np if isinstance(basis, Basis) else util._host(basis)
    isherm_basis = (basis.isherm if isinstance(basis, Basis)
                    else np.allclose(b, b.conj().swapaxes(-1, -2)))

    if isinstance(M, torch.Tensor):
        b_t = (basis.tensor(M.device) if isinstance(basis, Basis)
               else torch.as_tensor(b, device=M.device))
        coeffs = torch.einsum('...ab,jba->...j', M.to(config.COMPLEX), b_t)
        if not normalized:
            norm = torch.einsum('jab,jba->j', b_t, b_t)
            coeffs = coeffs / (norm.real if isherm_basis else norm)
        if hermitian and isherm_basis:
            coeffs = coeffs.real
        if tidyup:
            coeffs = util.remove_float_errors(coeffs, b.shape[-1]**3)
        return coeffs

    M = np.asarray(M)
    coeffs = np.tensordot(M, b, axes=[(-2, -1), (-1, -2)])
    if hermitian and isherm_basis:
        coeffs = coeffs.real
    if not normalized:
        norm = np.einsum('bij,bji->b', b, b)
        coeffs = coeffs / (norm.real if hermitian and isherm_basis else norm)
    return util.remove_float_errors(coeffs) if tidyup else coeffs


def ggm_expand(M, traceless: bool = False, hermitian: bool = False,
               tidyup: bool = False):
    r"""Expansion coefficients in the GGM basis from its explicit
    construction, without inner products; vectorized over leading axes.
    A tensor gives a tensor on its device, numpy input numpy."""
    is_tensor = isinstance(M, torch.Tensor)
    M = M.to(config.COMPLEX) if is_tensor else np.asarray(M)
    if M.shape[-1] != M.shape[-2]:
        raise ValueError('M should be square in its last two axes')
    square = M.ndim < 3
    if square:
        M = M[None]
    d = M.shape[-1]
    n_sym = d * (d - 1) // 2
    rows, cols = np.triu_indices(d, k=1)
    el = np.arange(1, d)
    el_norm = np.sqrt(el * (el + 1))
    if is_tensor:
        rows, cols, el, el_norm = (torch.as_tensor(x, device=M.device)
                                   for x in (rows, cols, el, el_norm))
        coeffs = torch.zeros((*M.shape[:-2], d * d), device=M.device,
                             dtype=config.REAL if hermitian
                             else config.COMPLEX)
        diag = torch.diagonal(M, 0, -2, -1)
    else:
        coeffs = np.zeros((*M.shape[:-2], d * d),
                          dtype=float if hermitian else complex)
        diag = np.diagonal(M, 0, -2, -1)

    def cast(x):
        return x.real if hermitian else x

    upper, lower = M[..., rows, cols], M[..., cols, rows]
    if not traceless:
        coeffs[..., 0] = cast(diag.sum(-1)) / np.sqrt(d)
    coeffs[..., 1:1 + n_sym] = cast(upper + lower) / np.sqrt(2)
    coeffs[..., 1 + n_sym:1 + 2 * n_sym] = cast(1j * (upper - lower)) \
        / np.sqrt(2)
    coeffs[..., 2 * n_sym + el] = cast(diag[..., :-1].cumsum(-1)
                                       - el * diag[..., 1:]) / el_norm
    if square:
        coeffs = coeffs[0]
    if tidyup:
        coeffs = util.remove_float_errors(coeffs)
    return coeffs


# -----------------------------------------------------------------------------
# Pauli structure constants and index maps (host-side, exact)
# -----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _pauli_mult_table_1q() -> Tuple[np.ndarray, np.ndarray]:
    """Single-qubit table: P_a P_b = phase[a, b] P_{index[a, b]} for the
    unnormalized Paulis."""
    idx = np.zeros((4, 4), dtype=np.int64)
    phase = np.zeros((4, 4), dtype=complex)
    p = util.paulis
    for a in range(4):
        for b in range(4):
            prod = p[a] @ p[b]
            for c in range(4):
                ip = np.trace(p[c].conj().T @ prod) / 2
                if abs(ip) > 0.5:
                    idx[a, b] = c
                    phase[a, b] = ip
                    break
    return idx, phase


@functools.lru_cache(maxsize=None)
def _pauli_mult_table(n_qubits: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-qubit table: index (4^n, 4^n) int64 and phase (4^n, 4^n)
    complex128 with ``C_a C_b = phase[a, b] / sqrt(d) C_{index[a, b]}``
    for the normalized basis."""
    idx1, ph1 = _pauli_mult_table_1q()
    digits = np.array(list(iproduct(range(4), repeat=n_qubits)))  # (n, nq)
    a_dig = digits[:, None, :]
    b_dig = digits[None, :, :]
    phase = ph1[a_dig, b_dig].prod(axis=-1)
    weights = 4 ** np.arange(n_qubits - 1, -1, -1)
    index = (idx1[a_dig, b_dig] * weights).sum(axis=-1)
    return index.astype(np.int64), phase


def equivalent_pauli_basis_elements(idx, N: int) -> np.ndarray:
    """Indices of the N-qubit Pauli elements that act as the identity
    on every qubit outside *idx*, in the order of the Pauli basis of the
    qubits *idx* (sorted)."""
    idx = [idx] if isinstance(idx, (int, np.integer)) else list(idx)
    ranges = [range(4) if i in idx else [0] for i in range(N)]
    weights = 4 ** np.arange(N - 1, -1, -1)
    return np.array([int(np.dot(digits, weights))
                     for digits in iproduct(*ranges)])


def remap_pauli_basis_elements(order: Sequence[int], N: int) -> np.ndarray:
    """Index permutation of the N-qubit Pauli basis under the qubit
    permutation *order*: element ``lin`` maps to ``out[lin]``."""
    weights = 4 ** np.arange(N - 1, -1, -1)
    out = np.empty(4**N, dtype=np.int64)
    for lin, digits in enumerate(iproduct(range(4), repeat=N)):
        out[lin] = int(np.dot([digits[order[i]] for i in range(N)], weights))
    return out
