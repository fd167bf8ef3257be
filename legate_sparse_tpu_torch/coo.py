# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""COO arrays on PyTorch tensors.

Mirrors ``legate_sparse_tpu/coo.py``: a (row, col, data) triple on one
device.  COO is the assembly format (construction, concatenation);
compute goes through CSR (``tocsr`` is one stable sort by row,
duplicates kept), as in scipy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .base import CsrDelegateMixin, _is_scalar, _scalar_op
from .types import coord_dtype_for, to_torch_dtype
from .utils import as_tensor, device_of, to_numpy


class coo_array(CsrDelegateMixin):
    """Coordinate-format sparse array (scipy's ``coo_array`` surface).

    Constructor forms: ``coo_array((data, (row, col)), shape=...)``,
    ``coo_array(scipy_sparse)``, ``coo_array(A)`` for any sparse format
    of this package, ``coo_array(dense_2d)``.  ``device`` as for
    ``csr_array``."""

    format = "coo"

    def __init__(self, arg, shape=None, dtype=None, copy: bool = False,
                 device=None):
        from .csr import _is_scipy_sparse, csr_array

        if isinstance(arg, coo_array):
            dev = device_of(device, arg.data)
            row, col, data = (t.to(dev) for t in (arg.row, arg.col,
                                                  arg.data))
            shape = arg.shape if shape is None else tuple(shape)
        elif (isinstance(arg, tuple) and len(arg) == 2
              and isinstance(arg[1], tuple)):
            data, (row, col) = arg
            dev = device_of(device, data, row, col)
            row, col, data = (as_tensor(t, dev) for t in (row, col, data))
            if shape is None:
                shape = (int(row.max()) + 1 if row.numel() else 0,
                         int(col.max()) + 1 if col.numel() else 0)
        elif _is_scipy_sparse(arg):
            sc = arg.tocoo()
            dev = device_of(device)
            row, col, data = (as_tensor(t, dev)
                              for t in (sc.row, sc.col, sc.data))
            shape = sc.shape if shape is None else tuple(shape)
        elif hasattr(arg, "tocsr"):     # csr_array, dia_array, csc_array
            base = arg if isinstance(arg, csr_array) else arg.tocsr()
            if device is not None:
                base = csr_array(base, device=device)
            row, col, data = base._coo_parts()
            shape = base.shape if shape is None else tuple(shape)
        else:
            base = csr_array(arg, device=device)
            row, col, data = base._coo_parts()
            shape = base.shape
        self.shape: Tuple[int, int] = tuple(int(s) for s in shape)
        cdt = coord_dtype_for(max(self.shape) if self.shape else 1)
        self.row = row.to(cdt)
        self.col = col.to(cdt)
        if dtype is not None:
            data = data.to(to_torch_dtype(dtype))
        self.data = data.clone() if copy else data

    def _like(self, data) -> "coo_array":
        """Same coordinates (shared), new values, the same class."""
        out = type(self).__new__(type(self))
        out.shape = self.shape
        out.row, out.col = self.row, self.col
        out.data = data
        return out

    # ---------------- properties ----------------
    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dim(self) -> int:
        return 2

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def T(self):
        return self.transpose()

    # ---------------- conversions ----------------
    def tocsr(self, copy: bool = False):
        from .csr import csr_array

        return csr_array((self.data, (self.row, self.col)), shape=self.shape)

    def tocsc(self, copy: bool = False):
        return self.tocsr().tocsc()

    def _coo_parts(self):
        return self.row, self.col, self.data

    def tocoo(self, copy: bool = False):
        return coo_array(self, copy=copy) if copy else self

    def asformat(self, format, copy: bool = False):
        if format in (None, "coo"):
            return self
        return self.tocsr().asformat(format, copy=copy)

    def toarray(self, order=None, out=None):
        """A dense host numpy array, as the JAX package returns here."""
        dense = to_numpy(self.tocsr().todense(order=order))
        if out is None:
            return dense
        np.copyto(out, dense)
        return out

    todense = toarray

    def toscipy(self):
        import scipy.sparse as sp

        return sp.coo_array((to_numpy(self.data),
                             (to_numpy(self.row), to_numpy(self.col))),
                            shape=self.shape)

    def transpose(self, axes=None, copy: bool = False):
        if axes is not None:
            raise ValueError("Sparse matrices do not support an 'axes' "
                             "parameter")
        out = coo_array.__new__(coo_array)
        out.shape = (self.shape[1], self.shape[0])
        out.row, out.col = self.col, self.row
        out.data = self.data.clone() if copy else self.data
        return out

    # ---------------- ops ----------------
    def copy(self):
        return coo_array(self, copy=True)

    def astype(self, dtype, casting: str = "unsafe", copy: bool = True):
        out = self._like(self.data.to(to_torch_dtype(dtype)))
        out.__class__ = coo_array
        return out

    def conj(self, copy: bool = True):
        out = self._like(torch.conj_physical(self.data)
                         if self.data.is_complex() else self.data.clone())
        out.__class__ = coo_array
        return out

    def sum_duplicates(self) -> None:
        """Merge duplicate coordinates in place (through CSR)."""
        A = self.tocsr()
        A.sum_duplicates()
        self.row, self.col, self.data = A._coo_parts()

    def diagonal(self, k: int = 0):
        return self.tocsr().diagonal(k)

    def sum(self, axis=None, dtype=None, out=None):
        return self.tocsr().sum(axis=axis, dtype=dtype, out=out)

    def dot(self, other, out=None):
        return self.tocsr().dot(other, out=out)

    def __matmul__(self, other):
        return self.dot(other)

    def __mul__(self, other):
        if _is_scalar(other):
            return self._like(_scalar_op(self.data, other, torch.mul))
        # sparray semantics: * is element-wise.
        return self.multiply(other)

    def multiply(self, other):
        """Element-wise product, in COO (scipy keeps the format)."""
        return self.tocsr().multiply(other).asformat("coo")

    # __rmul__ stays the mixin's: it sends scalars back here and keeps
    # the spmatrix x * A = x @ A.

    def __neg__(self):
        return self * -1.0

    def __repr__(self) -> str:
        return (f"<{self.shape[0]}x{self.shape[1]} sparse array of type "
                f"'{self.dtype}' with {self.nnz} stored elements in "
                f"COOrdinate format on {self.device}>")


class coo_matrix(coo_array):
    """scipy's ``coo_matrix`` flavour: ``*`` and ``**`` are the matrix
    product and power."""

    _is_spmatrix = True

    def __pow__(self, n):
        from .csr import csr_matrix

        out = (csr_matrix(self.tocsr()) ** n).asformat("coo")
        out.__class__ = type(self)
        return out

    def __mul__(self, other):
        if _is_scalar(other):
            return coo_array.__mul__(self, other)
        return self.dot(other)
