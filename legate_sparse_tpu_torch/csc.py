# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""CSC arrays on PyTorch tensors.

Mirrors ``legate_sparse_tpu/csc.py``: a ``csc_array`` is the CSR
storage of its transpose, ``A (m, n) in CSC == A.T stored CSR (n, m)``,
so every operation reuses the CSR paths.  Construction from scipy's CSC
``(data, indices, indptr)`` is free (that triple is the CSR triple of
A.T); ``tocsr`` is one stable-sort transpose, cached on first use, so an
iterative caller pays it once and then reaches the CSR kernels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .base import CsrDelegateMixin, _is_scalar
from .utils import to_numpy


class csc_array(CsrDelegateMixin):
    """Compressed Sparse Column array (scipy's ``csc_array`` surface).
    ``device`` as for ``csr_array``."""

    format = "csc"

    def __init__(self, arg, shape=None, dtype=None, copy: bool = False,
                 device=None):
        from .csr import _is_scipy_sparse, csr_array

        self._csr = None
        if isinstance(arg, csc_array):
            self._t = csr_array(arg._t, dtype=dtype, copy=copy,
                                device=device)
            self.shape: Tuple[int, int] = arg.shape
            return
        if isinstance(arg, tuple) and len(arg) == 3:
            # (data, indices, indptr) in CSC layout: the CSR triple of A.T.
            if shape is None:
                raise ValueError("csc_array((data, indices, indptr)) "
                                 "requires shape")
            m, n = int(shape[0]), int(shape[1])
            self._t = csr_array(arg, shape=(n, m), dtype=dtype, copy=copy,
                                device=device)
            self.shape = (m, n)
            return
        if _is_scipy_sparse(arg):
            sc = arg.tocsc()
            m, n = sc.shape
            self._t = csr_array((sc.data, sc.indices, sc.indptr),
                                shape=(n, m), dtype=dtype, copy=copy,
                                device=device)
            self.shape = (m, n)
            return
        # Dense, csr_array, another format, a COO tuple: through CSR,
        # then the transpose.
        A = csr_array(arg, shape=shape, dtype=dtype, copy=copy,
                      device=device)
        self._t = A.transpose()
        self.shape = A.shape

    def _like(self, t) -> "csc_array":
        out = type(self).__new__(type(self))
        out._t = t
        out._csr = None
        out.shape = self.shape
        return out

    # ---------------- properties ----------------
    @property
    def dtype(self) -> torch.dtype:
        return self._t.dtype

    @property
    def device(self) -> torch.device:
        return self._t.device

    @property
    def dim(self) -> int:
        return 2

    @property
    def nnz(self) -> int:
        return self._t.nnz

    @property
    def data(self) -> torch.Tensor:
        return self._t.data

    @property
    def indices(self) -> torch.Tensor:
        return self._t.indices

    @property
    def indptr(self) -> torch.Tensor:
        return self._t.indptr

    @property
    def T(self):
        return self.transpose()

    # ---------------- conversions ----------------
    def tocsr(self, copy: bool = False):
        """The CSR form, transposed once and cached; each call hands out
        a wrapper that shares the cached structure, so a caller that
        mutates it cannot corrupt the cache."""
        if self._csr is None:
            self._csr = self._t.transpose()
        return self._csr._with_data(self._csr.data, copy=copy)

    def tocsc(self, copy: bool = False):
        return csc_array(self, copy=copy) if copy else self

    def asformat(self, format, copy: bool = False):
        if format in (None, "csc"):
            return self
        if format == "csr":
            return self.tocsr()
        return self.tocsr().asformat(format, copy=copy)

    def toarray(self, order=None, out=None):
        """A dense host numpy array, as the JAX package returns here."""
        dense = to_numpy(self._t.todense(order=order)).T
        if out is None:
            return dense
        np.copyto(out, dense)
        return out

    todense = toarray

    def toscipy(self):
        return self._t.toscipy().T.tocsc()

    def transpose(self, axes=None, copy: bool = False):
        if axes is not None:
            raise ValueError("Sparse matrices do not support an 'axes' "
                             "parameter")
        # The stored CSR is the transpose: a wrapper sharing it, so a
        # mutation of the result cannot rewrite this array.
        return self._t._with_data(self._t.data, copy=copy)

    # ---------------- ops ----------------
    def copy(self):
        return csc_array(self, copy=True)

    def astype(self, dtype, casting: str = "unsafe", copy: bool = True):
        out = self._like(self._t.astype(dtype, casting=casting, copy=copy))
        out.__class__ = csc_array
        return out

    def conj(self, copy: bool = True):
        out = self._like(self._t.conj(copy=copy))
        out.__class__ = csc_array
        return out

    def diagonal(self, k: int = 0):
        return self._t.diagonal(-k)     # diag_k(A) == diag_-k(A.T)

    def sum(self, axis=None, dtype=None, out=None):
        if axis is None:
            return self._t.sum(axis=None, dtype=dtype, out=out)
        if axis in (0, -2):
            return self._t.sum(axis=1, dtype=dtype, out=out)
        if axis in (1, -1):
            return self._t.sum(axis=0, dtype=dtype, out=out)
        raise ValueError(f"invalid axis {axis}")

    def dot(self, other, out=None):
        return self.tocsr().dot(other, out=out)

    def __matmul__(self, other):
        return self.dot(other)

    def __mul__(self, other):
        if _is_scalar(other):
            return self._like(self._t * other)
        # sparray semantics: * is element-wise.
        return self.multiply(other)

    def multiply(self, other):
        """Element-wise product, in CSC (scipy keeps the format)."""
        return self.tocsr().multiply(other).tocsc()

    # __rmul__ stays the mixin's: it sends scalars back here and keeps
    # the spmatrix x * A = x @ A.

    def __neg__(self):
        return self * -1.0

    def __repr__(self) -> str:
        return (f"<{self.shape[0]}x{self.shape[1]} sparse array of type "
                f"'{self.dtype}' with {self.nnz} stored elements in "
                f"Compressed Sparse Column format on {self.device}>")


class csc_matrix(csc_array):
    """scipy's ``csc_matrix`` flavour: ``*`` and ``**`` are the matrix
    product and power."""

    _is_spmatrix = True

    def __pow__(self, n):
        from .csr import csr_matrix

        out = (csr_matrix(self.tocsr()) ** n).asformat("csc")
        out.__class__ = type(self)
        return out

    def __mul__(self, other):
        if _is_scalar(other):
            return csc_array.__mul__(self, other)
        return self.dot(other)
