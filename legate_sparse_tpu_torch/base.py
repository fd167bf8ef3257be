# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Shared base classes of the sparse formats.

Mirrors ``legate_sparse_tpu/base.py``:

- ``CsrDelegateMixin`` (``:21-177``): every operation a format does not
  implement itself goes through CSR, so ``csr``, ``csc``, ``coo`` and
  ``dia`` share one scipy surface;
- ``CompressedBase`` (``:180-307``): format dispatch, ``astype`` with
  structure sharing, ``sum``, ``max``/``min`` and ``mean``;
- the zero-preserving unary ufuncs (``:313-333``), each applied to the
  stored values through its torch counterpart (``_UFUNCS``).

The axis reductions give the same result on every call on CUDA: the
float sums are segment sums (``ops/convert.py::segment_sum``), over
column-sorted values for ``axis=0``, where the JAX package scatter-adds
(``.at[].add``, an atomic add on CUDA).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops import convert as _convert
from .types import to_torch_dtype
from .utils import fill_out, to_inexact, true_divide_type


class CsrDelegateMixin:
    """Operations every format has by converting to CSR (where the
    implementations live); a format overrides any of them with its
    own."""

    # numpy defers binary operators to the sparse operand (scipy sets
    # the same priority); torch returns NotImplemented for an operand it
    # does not know, so ``tensor * A`` reaches ``__rmul__`` as well.
    __array_priority__ = 10.1

    @property
    def ndim(self) -> int:
        return 2

    def multiply(self, other):
        return self.tocsr().multiply(other)

    def power(self, n, dtype=None):
        return self.tocsr().power(n, dtype=dtype)

    def maximum(self, other):
        return self.tocsr().maximum(other)

    def minimum(self, other):
        return self.tocsr().minimum(other)

    def trace(self, offset: int = 0):
        return self.tocsr().trace(offset)

    def count_nonzero(self, axis=None):
        return self.tocsr().count_nonzero(axis=axis)

    def argmax(self, axis=None, out=None):
        return self.tocsr().argmax(axis=axis, out=out)

    def argmin(self, axis=None, out=None):
        return self.tocsr().argmin(axis=axis, out=out)

    def reshape(self, *shape, order="C"):
        return self.tocsr().reshape(*shape, order=order)

    def tocoo(self, copy: bool = False):
        return self.tocsr().tocoo(copy=copy)

    def todok(self, copy: bool = False):
        return self.tocsr().todok(copy=copy)

    def tolil(self, copy: bool = False):
        return self.tocsr().tolil(copy=copy)

    # The *_matrix flavours set this: their ``*`` is the matrix product,
    # and results routed through CSR keep the matrix flavour.
    _is_spmatrix = False

    def _flavored(self, out):
        if self._is_spmatrix:
            from .csr import csr_array, csr_matrix

            if type(out) is csr_array:
                out.__class__ = csr_matrix
        return out

    def __mul__(self, other):
        if _is_scalar(other):
            if hasattr(self, "_with_data"):
                return self._with_data(_scalar_op(self.data, other,
                                                  torch.mul))
            return self._flavored(self.tocsr() * other)
        if self._is_spmatrix:
            return self._flavored(self.tocsr() @ other)
        return self.multiply(other)

    def __rmul__(self, other):
        if _is_scalar(other):
            return self.__mul__(other)
        if self._is_spmatrix:
            # scipy's spmatrix: x * A is x @ A (a row-vector product).
            from .utils import as_tensor, to_numpy

            other = as_tensor(other, self.device)
            AT = self.tocsr().transpose()
            if other.dim() == 1:
                return to_numpy(AT @ other)
            return to_numpy(AT @ other.T).T
        return self.__mul__(other)   # the element-wise product commutes

    def __neg__(self):
        if hasattr(self, "_with_data"):
            return self._with_data(-self.data)
        return self._flavored(-self.tocsr())

    def __truediv__(self, other):
        if _is_scalar(other) and hasattr(self, "_with_data"):
            return self._with_data(_scalar_op(self.data, other, torch.div,
                                              true_divide_type))
        return self._flavored(self.tocsr() / other)

    def __add__(self, other):
        if np.isscalar(other) and other == 0:
            return self.copy()   # sum() and accumulations start at 0
        return self._flavored(self.tocsr() + other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._flavored(self.tocsr() - other)

    def __rsub__(self, other):
        if np.isscalar(other) and other == 0:
            return self.__neg__()
        raise NotImplementedError(
            "dense - sparse is not supported; densify explicitly")

    def __matmul__(self, other):
        return self.tocsr() @ other

    def __rmatmul__(self, other):
        raise NotImplementedError(
            f"dense @ {type(self).__name__} is not supported")

    # Element-wise comparisons through CSR.  Defining __eq__ clears the
    # hash: sparse arrays are mutable and unhashable, as scipy's are.
    __hash__ = None

    def __eq__(self, other):
        return self.tocsr() == other

    def __ne__(self, other):
        return self.tocsr() != other

    def __lt__(self, other):
        return self.tocsr() < other

    def __gt__(self, other):
        return self.tocsr() > other

    def __le__(self, other):
        return self.tocsr() <= other

    def __ge__(self, other):
        return self.tocsr() >= other

    def __abs__(self):
        return abs(self.tocsr())

    def __pow__(self, n):
        if np.isscalar(n) and n == 0:
            raise NotImplementedError(
                "zero power is not supported as it would densify the "
                "matrix; use np.ones(A.shape, dtype=A.dtype)")
        return self.power(n)

    def nonzero(self):
        return self.tocsr().nonzero()


def _is_scalar(other) -> bool:
    return np.isscalar(other) or getattr(other, "ndim", None) == 0


def _scalar_dtype(dtype: torch.dtype, other, rule=None):
    """(result dtype, Python value) of an array of ``dtype`` with the
    scalar ``other``, by ``rule`` (default ``utils.result_type``): a
    Python scalar is weak, a numpy scalar or a 0-d array or tensor has
    its own dtype."""
    from .utils import result_type

    rule = rule or result_type
    if isinstance(other, torch.Tensor):
        return rule(dtype, other.dtype), other.item()
    if isinstance(other, (np.ndarray, np.generic)):
        return rule(dtype, to_torch_dtype(other.dtype)), other.item()
    return rule(dtype, other), other


def _scalar_op(data: torch.Tensor, other, op, rule=None):
    """``op(data, other)`` for a scalar ``other``, in the dtype ``jnp``
    gives (``_scalar_dtype``)."""
    dtype, other = _scalar_dtype(data.dtype, other, rule)
    return op(data.to(dtype), other).to(dtype)


def _is_integral(n) -> bool:
    if isinstance(n, (bool, int, np.integer)):
        return True
    dt = getattr(n, "dtype", None)
    if isinstance(dt, torch.dtype):
        return not (dt.is_floating_point or dt.is_complex)
    return dt is not None and not np.issubdtype(dt, np.inexact)


def _power(data: torch.Tensor, n) -> torch.Tensor:
    """``jnp.power(data, n)`` for a scalar ``n``: an integral exponent
    keeps the values' dtype (bool becomes int32), as ``jnp``'s
    ``integer_pow`` does; any other follows ``_scalar_dtype``."""
    if not _is_integral(n):
        return _scalar_op(data, n, torch.pow)
    dtype = torch.int32 if data.dtype == torch.bool else data.dtype
    n = int(n)
    if n < 0 and not (dtype.is_floating_point or dtype.is_complex):
        raise TypeError("integers to negative integer powers are not "
                        "allowed")
    return torch.pow(data.to(dtype), n).to(dtype)


def _extreme(a: torch.Tensor, b: torch.Tensor, name: str) -> torch.Tensor:
    """``jnp.maximum`` (``name="max"``) or ``jnp.minimum`` of two
    tensors of one dtype: NaN propagates; complex values are ordered
    lexicographically (real part, then imaginary), as in numpy."""
    if not a.is_complex():
        return (torch.maximum if name == "max" else torch.minimum)(a, b)
    x, y = (a, b) if name == "max" else (b, a)
    a_wins = (x.real > y.real) | ((x.real == y.real) & (x.imag > y.imag))
    nan_a = torch.isnan(a.real) | torch.isnan(a.imag)
    nan_b = torch.isnan(b.real) | torch.isnan(b.imag)
    return torch.where(nan_a | (a_wins & ~nan_b), a, b)


class CompressedBase(CsrDelegateMixin):
    """Base of ``csr_array`` and ``dia_array``: format dispatch, value
    casts, sums, max/min and the zero-preserving ufuncs.  Subclasses
    provide ``shape``, ``dtype``, ``nnz``, ``data``, ``copy`` and
    ``_with_data``."""

    format: str = ""
    shape: tuple

    @property
    def device(self) -> torch.device:
        return self.data.device

    def asformat(self, format, copy: bool = False):
        """Dispatch to ``to<format>()`` (reference ``base.py:182-192``)."""
        if format is None or format == self.format:
            return self.copy() if copy else self
        convert = getattr(self, "to" + format, None)
        if convert is None:
            raise ValueError(f"Format {format} is unknown.")
        return convert(copy=copy)

    def astype(self, dtype, casting: str = "unsafe", copy: bool = True):
        """Cast the values, sharing structure (reference ``base.py:194-199``)."""
        dtype = to_torch_dtype(dtype)
        if self.dtype != dtype:
            return self._with_data(self.data.to(dtype))
        return self.copy() if copy else self

    def sum(self, axis=None, dtype=None, out=None):
        """The sum of all values, of each column (``axis=0``) or of each
        row (``axis=1``); the same result on every call on CUDA."""
        from .csr import csr_array

        if not isinstance(self, csr_array):
            return self.tocsr().sum(axis=axis, dtype=dtype, out=out)
        rows, cols = self.shape
        data = self.data
        if axis is None:
            result = torch.sum(data)
        elif axis in (0, -2):
            order = torch.argsort(self.indices, stable=True)
            counts = torch.bincount(self.indices.to(torch.int64),
                                    minlength=cols)
            result = _convert.segment_sum(data[order], counts)
        elif axis in (1, -1):
            result = _convert.segment_sum(
                data, self.indptr[1:] - self.indptr[:-1])
        else:
            raise ValueError(f"invalid axis {axis}")
        if dtype is not None:
            result = result.to(to_torch_dtype(dtype))
        return fill_out(result, out, check_shape=False)

    def _minmax(self, axis, op_name: str):
        """Shared max/min, scipy's semantics: the implicit zeros take
        part wherever a row, column or the matrix is not full."""
        from .csr import csr_array

        if not isinstance(self, csr_array):
            return getattr(self.tocsr(), op_name)(axis=axis)
        if self.nnz and not self.has_canonical_format:
            # scipy canonicalises first: duplicates count as their sum,
            # and the fullness test counts coordinates, not slots.
            self.sum_duplicates()
        rows, cols = self.shape
        if axis is None and rows * cols == 0:
            raise ValueError("zero-size array to reduction operation")
        if axis in (1, -1) and cols == 0 and rows > 0:
            raise ValueError("zero-size array to reduction operation")
        if axis in (0, -2) and rows == 0 and cols > 0:
            raise ValueError("zero-size array to reduction operation")
        data = self.data
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        pick = torch.maximum if op_name == "max" else torch.minimum
        if axis is None:
            if self.nnz == 0:
                return zero
            r = torch.amax(data) if op_name == "max" else torch.amin(data)
            return pick(r, zero) if self.nnz < rows * cols else r
        if axis in (1, -1):
            counts = self.indptr[1:] - self.indptr[:-1]
            r = _convert.segment_extreme(data, counts, op_name)
            r = torch.where(counts > 0, r, zero)
            return torch.where(counts < cols, pick(r, zero), r)
        if axis in (0, -2):
            col = self.indices.to(torch.int64)
            if data.is_floating_point():
                init = -math.inf if op_name == "max" else math.inf
            else:
                info = torch.iinfo(data.dtype)
                init = info.min if op_name == "max" else info.max
            r = torch.full((cols,), init, dtype=data.dtype,
                           device=data.device).scatter_reduce(
                0, col, data, "amax" if op_name == "max" else "amin")
            counts = torch.bincount(col, minlength=cols)
            r = torch.where(counts > 0, r, zero)
            return torch.where(counts < rows, pick(r, zero), r)
        raise ValueError(f"invalid axis {axis}")

    def max(self, axis=None, out=None):
        """Maximum (scipy's semantics: the implicit zeros count unless the
        reduced extent is full)."""
        return fill_out(self._minmax(axis, "max"), out, check_shape=False)

    def min(self, axis=None, out=None):
        """Minimum (scipy's ``min`` semantics)."""
        return fill_out(self._minmax(axis, "min"), out, check_shape=False)

    def mean(self, axis=None, dtype=None, out=None):
        rows, cols = self.shape
        denom = {None: rows * cols, 0: rows, -2: rows, 1: cols,
                 -1: cols}[axis]
        s = self.sum(axis=axis, dtype=dtype)
        result = s.to(true_divide_type(s.dtype, denom)) / denom
        return fill_out(result, out, check_shape=False)

    def __matmul__(self, other):
        return self.dot(other)


def _rint(x):
    if x.is_complex():
        return torch.complex(torch.round(x.real), torch.round(x.imag))
    return torch.round(x)


def _scale(factor):
    def op(x):
        return x * torch.tensor(factor, dtype=x.dtype, device=x.device)
    return op


def _sign(x):
    return torch.sgn(x) if x.is_complex() else torch.sign(x)


# Univariate ufuncs with f(0) = 0, applied to the stored values
# (reference ``base.py:313-333``, the same names), with the torch
# function of the same semantics: ``rint`` rounds half to even, the
# complex ``sign`` is x/|x| (``torch.sgn``), ``deg2rad``/``rad2deg``
# multiply by the constant in the values' dtype as ``jnp`` does.
_UFUNCS = {
    "sin": torch.sin, "tan": torch.tan, "arcsin": torch.asin,
    "arctan": torch.atan, "sinh": torch.sinh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arctanh": torch.atanh, "rint": _rint,
    "sign": _sign, "expm1": torch.expm1, "log1p": torch.log1p,
    "deg2rad": _scale(math.pi / 180.0), "rad2deg": _scale(180.0 / math.pi),
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    "sqrt": torch.sqrt,
}
_UFUNCS_WITH_FIXED_POINT_AT_ZERO = tuple(_UFUNCS)
# These keep an integer dtype; ``rint`` makes it float64 and the rest
# make it inexact (``utils.to_inexact``), as ``jnp`` does.
_INTEGER_PRESERVING = ("sign", "floor", "ceil", "trunc")


def _install_unary_ufuncs(cls) -> None:
    for name, op in _UFUNCS.items():
        def method(self, _op=op, _name=name):
            data = self.data
            if not (data.is_floating_point() or data.is_complex()):
                if _name in _INTEGER_PRESERVING:
                    return self._with_data(_op(data) if _name == "sign"
                                           else data.clone())
                data = data.to(torch.float64 if _name == "rint"
                               else to_inexact(data.dtype))
            return self._with_data(_op(data))

        method.__name__ = name
        method.__doc__ = f"Element-wise {name} (zero-preserving)."
        setattr(cls, name, method)


_install_unary_ufuncs(CompressedBase)


class DenseSparseBase:
    """Base of the formats with a structure-sharing constructor (CSR;
    reference ``base.py:256-268``)."""

    @classmethod
    def make_with_same_nnz_structure(cls, mat, arg, shape=None, dtype=None):
        """``cls(arg)`` with ``mat``'s shape and dtype unless given, on
        ``mat``'s device."""
        if shape is None:
            shape = mat.shape
        if dtype is None:
            dtype = mat.dtype
        return cls(arg, shape=shape, dtype=dtype, device=mat.device)
