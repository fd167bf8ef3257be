# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""CSR arrays on PyTorch tensors.

Mirrors ``legate_sparse_tpu/csr.py::csr_array``: storage is three
tensors on one device — ``data`` (nnz), ``indices`` (nnz, int32 unless
an extent needs int64) and ``indptr`` (rows+1, int64).  This port
carries the constructors (``(data, indices, indptr)``, COO ``(data,
(row, col))``, the empty ``(M, N)``, scipy, dense), ``nnz``,
``has_canonical_format``, ``todense``/``toscipy``, ``diagonal``,
``transpose``/``T``, the structure caches of the SpMV hot path and
``dot``, which dispatches by operand and structure in the JAX
package's order:

========================  ==============================================
label                     SpMV (``spmv_path``) and SpMM (``spmm_path``)
========================  ==============================================
``"dia-kernel"``          banded, f32/bf16 (SpMM: k <= 1024):
                          ``ops/dia_kernel.py``
``"dia-torch"``           banded, other dtypes or wider X:
                          ``ops/dia_ops.py``
``"bsr"``                 present 128x128 blocks within budget, on CUDA
                          (or anywhere under ``bsr_force``); SpMM k <= 512
``"ell"``                 padded rows within ``ell_max_expand``
``"csr-rowids"``          gather + segment sum, cached row ids
``"csr"``                 the operand's dtype promoted the matrix
========================  ==============================================

A sparse operand (``csr_array``, ``dia_array``, scipy) takes SpGEMM,
``spgemm_csr_csr_csr``, labelled in ``spgemm_path``: ``"dia-kernel"``
(both operands exact bands, f32/bf16: ``csrc/dia_spgemm.cu``),
``"dia-torch"`` (exact bands, other dtypes) or ``"esc"``
(``ops/spgemm.py``).  The JAX package's engine/autotune/resilience
routes and low-precision widening are not part of the port yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .base import CompressedBase
from .ops import convert as _convert
from .ops import dia_kernel as _dia_kernel
from .ops import dia_ops as _dia_ops
from .ops import spgemm as _spgemm_ops
from .ops import spmv as _spmv_ops
from .runtime import default_float
from .settings import settings
from .types import check_nnz, coord_dtype_for, nnz_dtype, to_torch_dtype
from .utils import (as_tensor, cast_to_common_type, device_of, fill_out,
                    find_common_type, require_supported_dtype, to_numpy)


def _is_scipy_sparse(obj) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover
        return False
    return sp.issparse(obj)


class csr_array(CompressedBase):
    """Compressed Sparse Row array backed by PyTorch tensors.

    Constructor forms: ``csr_array(dense_2d)``, ``csr_array(scipy_sparse)``,
    ``csr_array(other_csr)``, ``csr_array((M, N))`` (empty),
    ``csr_array((data, (row, col)), shape=...)`` (COO, stably sorted by
    row, duplicates kept) and ``csr_array((data, indices, indptr),
    shape=...)``.  ``device`` names where the tensors live; without it a
    tensor input keeps its device and anything else goes to the default
    device (``runtime.default_device``)."""

    format = "csr"

    def __init__(self, arg, shape=None, dtype=None, copy: bool = False,
                 device=None):
        canonical: Optional[bool] = None
        if isinstance(arg, csr_array):
            dev = device_of(device, arg.data)
            shape = arg.shape if shape is None else tuple(shape)
            data = arg.data.to(dev)
            indices = arg.indices.to(dev)
            indptr = arg.indptr.to(dev)
            canonical = arg._canonical
        elif _is_scipy_sparse(arg):
            arg = arg.tocsr()
            dev = device_of(device)
            if shape is None:
                shape = arg.shape
            check_nnz(int(arg.nnz))
            data = as_tensor(arg.data, dev)
            indices = as_tensor(arg.indices, dev,
                                dtype=coord_dtype_for(max(arg.shape)))
            indptr = as_tensor(arg.indptr, dev, dtype=nnz_dtype())
            canonical = bool(arg.has_canonical_format)
        elif (isinstance(arg, tuple) and len(arg) == 2
              and all(isinstance(s, (int, np.integer)) for s in arg)):
            dev = device_of(device)
            shape = (int(arg[0]), int(arg[1]))
            data = torch.zeros((0,), dtype=to_torch_dtype(
                dtype if dtype is not None else default_float), device=dev)
            indices = torch.zeros((0,), dtype=coord_dtype_for(max(shape)),
                                  device=dev)
            indptr = torch.zeros((shape[0] + 1,), dtype=nnz_dtype(),
                                 device=dev)
            canonical = True
        elif (isinstance(arg, tuple) and len(arg) == 2
              and isinstance(arg[1], tuple)):
            data_in, (row_in, col_in) = arg
            dev = device_of(device, data_in, row_in, col_in)
            data_in = as_tensor(data_in, dev)
            row_in = as_tensor(row_in, dev)
            col_in = as_tensor(col_in, dev)
            check_nnz(int(data_in.shape[0]))
            if shape is None:
                shape = (int(row_in.max()) + 1, int(col_in.max()) + 1)
            shape = tuple(int(s) for s in shape)
            cdt = coord_dtype_for(max(shape))
            data, indices, indptr = _convert.coo_to_csr(
                row_in.to(cdt), col_in.to(cdt), data_in, shape[0])
        elif isinstance(arg, tuple) and len(arg) == 3:
            data_in, indices_in, indptr_in = arg
            dev = device_of(device, data_in, indices_in, indptr_in)
            indptr = as_tensor(indptr_in, dev, dtype=nnz_dtype())
            indices = as_tensor(indices_in, dev)
            check_nnz(int(indices.shape[0]))
            if shape is None:
                cols = (int(indices.max()) + 1) if indices.numel() else 0
                shape = (indptr.shape[0] - 1, cols)
            shape = tuple(int(s) for s in shape)
            indices = indices.to(coord_dtype_for(max(shape)))
            data = as_tensor(data_in, dev)
        else:
            dev = device_of(device, arg)
            dense = as_tensor(arg, dev)
            if dense.dim() != 2:
                raise ValueError(f"csr_array requires a 2-D input, got "
                                 f"ndim={dense.dim()}")
            if dtype is not None:
                dense = dense.to(to_torch_dtype(dtype))
            if shape is not None and tuple(shape) != tuple(dense.shape):
                raise ValueError("shape mismatch with dense input")
            shape = tuple(dense.shape)
            data, indices, indptr = _convert.dense_to_csr(dense)
            canonical = True
        if dtype is not None:
            data = data.to(to_torch_dtype(dtype))
        if copy:
            data, indices, indptr = data.clone(), indices.clone(), indptr.clone()
        self._data = data
        self._indices = indices
        self._indptr = indptr
        self._canonical = canonical
        self.shape: Tuple[int, int] = tuple(int(s) for s in shape)
        if self._indptr.shape[0] != self.shape[0] + 1:
            raise ValueError(f"indptr length {self._indptr.shape[0]} != "
                             f"rows+1 ({self.shape[0] + 1})")
        # Static-structure caches of the SpMV hot path, built lazily on
        # the first matvec (False = tried, not applicable).
        self._row_ids = None
        self._ell = None
        self._ell_width = None
        self._dia = None
        self._dia_offsets = None
        self._dia_pack = None
        self._bsr = None
        # Labels of the paths the last SpMV, SpMM and SpGEMM (with this
        # matrix on the left) took.
        self.spmv_path: Optional[str] = None
        self.spmm_path: Optional[str] = None
        self.spgemm_path: Optional[str] = None

    @classmethod
    def _from_parts(cls, data, indices, indptr, shape,
                    canonical: Optional[bool] = True) -> "csr_array":
        """Internal constructor for row-sorted kernel outputs."""
        obj = cls((data, indices, indptr), shape=shape)
        obj._canonical = canonical
        return obj

    def _with_data(self, data) -> "csr_array":
        """Same structure, new values (structure caches shared)."""
        out = type(self)._from_parts(data, self._indices, self._indptr,
                                     self.shape, canonical=self._canonical)
        out._row_ids = self._row_ids
        out._ell_width = self._ell_width
        out._dia_offsets = self._dia_offsets
        return out

    def copy(self) -> "csr_array":
        return csr_array(self, copy=True)

    # ---------------- properties ----------------
    @property
    def nnz(self) -> int:
        return int(self._data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def indices(self) -> torch.Tensor:
        return self._indices

    @property
    def indptr(self) -> torch.Tensor:
        return self._indptr

    @property
    def has_canonical_format(self) -> bool:
        """Indices strictly increasing within every row (sorted, no
        duplicates); computed once for inputs of unknown order."""
        if self._canonical is None:
            if self.nnz < 2:
                self._canonical = True
            else:
                row_ids = self._get_row_ids()
                same_row = row_ids[1:] == row_ids[:-1]
                increasing = self._indices[1:] > self._indices[:-1]
                self._canonical = bool(torch.all(~same_row | increasing))
        return self._canonical

    # ---------------- conversions ----------------
    def todense(self) -> torch.Tensor:
        return _convert.csr_to_dense(self._data, self._indices,
                                     self._indptr, self.shape)

    toarray = todense

    def tocsr(self, copy: bool = False) -> "csr_array":
        return self.copy() if copy else self

    def toscipy(self):
        """Host scipy ``csr_array`` (bf16 values widen to float32)."""
        import scipy.sparse as sp

        return sp.csr_array((to_numpy(self._data), to_numpy(self._indices),
                             to_numpy(self._indptr)), shape=self.shape)

    # ---------------- structure ops ----------------
    def diagonal(self, k: int = 0) -> torch.Tensor:
        """Diagonal ``k`` (scipy's length; absent entries 0, duplicates
        summed)."""
        rows, cols = self.shape
        full = _convert.csr_diagonal(self._data, self._indices,
                                     self._indptr, rows, k)
        length = max(0, min(rows + min(k, 0), cols - max(k, 0)))
        start = -min(k, 0)
        return full[start:start + length]

    def transpose(self, axes=None, copy: bool = False):
        if axes is not None:
            raise ValueError("Sparse matrices do not support an 'axes' "
                             "parameter")
        rows, cols = self.shape
        data, indices, indptr = _convert.csr_transpose(
            self._data, self._indices, self._indptr, rows, cols)
        # The transpose of a canonical matrix is canonical; type(self)
        # keeps the csr_matrix flavour.
        return type(self)._from_parts(data, indices, indptr, (cols, rows),
                                      canonical=self._canonical)

    @property
    def T(self):
        return self.transpose()

    # ---------------- cached matvec structure ----------------
    def _get_row_ids(self) -> torch.Tensor:
        if self._row_ids is None:
            self._row_ids = _convert.row_ids_from_indptr(self._indptr,
                                                         self.nnz)
        return self._row_ids

    def _get_ell(self):
        """Cached ELL pack, or None (padding over budget)."""
        if self._ell is not None:
            return self._ell if self._ell is not False else None
        rows = self.shape[0]
        if self._ell_width is None:
            self._ell_width = (
                max(int((self._indptr[1:] - self._indptr[:-1]).max()), 1)
                if rows and self.nnz else 1)
        W = self._ell_width
        if not _spmv_ops.ell_within_budget(rows, W, self.nnz,
                                           settings.ell_max_expand):
            self._ell = False
            return None
        self._ell = _spmv_ops.ell_pack(self._data, self._indices,
                                       self._indptr, rows, W)
        return self._ell

    def _get_bsr(self):
        """Cached BSR structure, or None.

        Built for a CUDA-resident canonical f32/bf16 matrix whose
        present 128x128 blocks fit ``bsr_max_expand`` and
        ``MAX_BLOCKS`` (the JAX package builds it on the TPU alone); on
        any device under ``bsr_force``.  It is built from the matrix's
        device tensors and holds the block list only, beside references
        to them.  Zero slots inside a present block multiply x, as in
        scipy's ``bsr_array``: a non-finite x in a column CSR never
        stores can give NaN here."""
        if self._bsr is not None:
            return self._bsr if self._bsr is not False else None
        if not settings.bsr_force and self.device.type != "cuda":
            self._bsr = False
            return None
        if (settings.bsr_max_expand <= 0
                or self.dtype not in (torch.float32, torch.bfloat16)
                or not self.has_canonical_format):
            self._bsr = False
            return None
        from .ops import bsr as _bsr_ops

        st = _bsr_ops.build_structure(
            self._data, self._indices, self._indptr, self._get_row_ids(),
            self.shape, settings.bsr_max_expand)
        self._bsr = st if st is not None else False
        return st

    def _get_dia(self):
        """Cached banded structure ``(dia_data, offsets, mask)``, or None.

        A matrix is banded when its distinct diagonals number at most
        ``min(dia_max_diags, dia_max_expand * nnz / cols)``.  ``mask``
        is None for an exact band (every in-bounds slot explicit) and
        the explicit-entry mask for a band with holes, so a hole never
        multiplies x.  bf16 storage drops the mask, as the JAX package
        does for compressed storage: its band is zero-filled."""
        if self._dia is not None:
            return self._dia if self._dia is not False else None
        rows, cols = self.shape
        nnz = self.nnz
        if (settings.dia_max_expand <= 0 or not nnz or not rows
                or not self.has_canonical_format):
            self._dia = False
            return None
        if self._dia_offsets is None:
            max_nd = int(min(settings.dia_max_diags,
                             settings.dia_max_expand * nnz / max(cols, 1)))
            offsets = (_dia_ops.csr_band_offsets(
                self._indices, self._get_row_ids(), max_nd)
                if max_nd >= 1 else None)
            self._dia_offsets = offsets if offsets is not None else False
        if self._dia_offsets is False:
            self._dia = False
            return None
        offsets = self._dia_offsets
        exact = _dia_ops.band_cover(offsets, self.shape, cols) == nnz
        if self.dtype in (torch.bfloat16, torch.float16):
            exact = True
        if exact:
            dia_data = _dia_ops.dia_from_csr(
                self._data, self._indices, self._get_row_ids(), offsets,
                cols)
            self._dia = (dia_data, offsets, None)
        else:
            dia_data, mask = _dia_ops.dia_from_csr(
                self._data, self._indices, self._get_row_ids(), offsets,
                cols, with_mask=True)
            self._dia = (dia_data, offsets, mask)
        return self._dia

    def _get_dia_pack(self):
        """Cached row-aligned pack for the DIA kernel, or None when the
        matrix is not banded or the kernel does not take the band."""
        if self._dia_pack is not None:
            return self._dia_pack if self._dia_pack is not False else None
        dia = self._get_dia()
        packed = None
        if dia is not None:
            dia_data, offsets, mask = dia
            packed = _dia_kernel.pack_band(dia_data, offsets, self.shape,
                                           mask=mask)
        self._dia_pack = packed if packed is not None else False
        return packed

    # ---------------- matmul ----------------
    def dot(self, other, out=None):
        """``A @ other`` (reference ``csr.py:1321-1579``): SpGEMM for a
        sparse operand (``csr_array``, ``dia_array``, scipy), SpMV for
        x of shape (cols,) or (cols, 1), SpMM for X of shape (cols, k).
        numpy inputs and tensors on another device move to the matrix's
        device."""
        require_supported_dtype(self.dtype)
        if _is_scipy_sparse(other):
            other = csr_array(other, device=self.device)
        elif (isinstance(other, CompressedBase)
              and not isinstance(other, csr_array)):
            other = other.tocsr()
        if isinstance(other, csr_array):
            if out is not None:
                raise ValueError("out not supported for sparse-sparse "
                                 "matmul")
            if other.device != self.device:
                other = csr_array(other, device=self.device)
            common = find_common_type(self.dtype, other.dtype)
            A = self.astype(common, copy=False)
            C = spgemm_csr_csr_csr(A, other.astype(common, copy=False))
            self.spgemm_path = A.spgemm_path
            return C
        x = as_tensor(other, self.device)
        squeeze = False
        if x.dim() == 2 and x.shape[1] == 1:
            x = x.reshape(-1)
            squeeze = True
        if x.dim() == 2:
            return fill_out(self._matmat(x), out)
        if x.dim() != 1 or x.shape[0] != self.shape[1]:
            raise ValueError(f"dimension mismatch: {self.shape} @ "
                             f"{tuple(x.shape)}")
        A, x = cast_to_common_type(self, x)
        src = self if A is self else None
        dia = src._get_dia() if src is not None else None
        bsr = (src._get_bsr() if src is not None and dia is None else None)
        ell = (src._get_ell()
               if src is not None and dia is None and bsr is None else None)
        rows = self.shape[0]
        if dia is not None:
            packed = src._get_dia_pack()
            if packed is not None:
                y = _dia_kernel.dia_spmv(packed, x.contiguous())
                path = "dia-kernel"
            else:
                y = _dia_ops.dia_spmv_nopad(dia[0], dia[2], x, dia[1],
                                            self.shape)
                path = "dia-torch"
        elif bsr is not None:
            y = bsr.matvec(x)
            path = "bsr"
        elif ell is not None:
            y = _spmv_ops.ell_spmv(ell[0], ell[1], ell[2], x)
            path = "ell"
        elif src is not None:
            y = _spmv_ops.csr_spmv_rowids(A.data, A.indices,
                                          src._get_row_ids(), x, rows)
            path = "csr-rowids"
        else:
            y = _spmv_ops.csr_spmv(A.data, A.indices, A.indptr, x, rows)
            path = "csr"
        self.spmv_path = path
        if squeeze:
            y = y[:, None]
        return fill_out(y, out)

    def _matmat(self, X: torch.Tensor) -> torch.Tensor:
        """SpMM ``A @ X`` for dense X (cols, k), in the SpMV branch's
        order DIA → BSR (k <= 512) → ELL → csr-rowids → csr; the label
        goes to ``spmm_path``."""
        from .ops.bsr import SPMM_MAX_K as _BSR_MAX_K

        if X.shape[0] != self.shape[1]:
            raise ValueError(f"dimension mismatch: {self.shape} @ "
                             f"{tuple(X.shape)}")
        A, X = cast_to_common_type(self, X)
        src = self if A is self else None
        k = X.shape[1]
        dia = src._get_dia() if src is not None else None
        bsr = (src._get_bsr()
               if src is not None and dia is None and 0 < k <= _BSR_MAX_K
               else None)
        ell = (src._get_ell()
               if src is not None and dia is None and bsr is None else None)
        rows = self.shape[0]
        if dia is not None:
            # The cheap k gate first: no kernel pack for an X the kernel
            # cannot take.
            packed = (src._get_dia_pack()
                      if 0 < k <= _dia_kernel.SPMM_MAX_K else None)
            if _dia_kernel.spmm_supported(packed, X):
                Y = _dia_kernel.dia_spmm(packed, X.contiguous())
                path = "dia-kernel"
            else:
                Y = _dia_ops.dia_spmm_masked(dia[0], dia[2], X, dia[1],
                                             self.shape)
                path = "dia-torch"
        elif bsr is not None:
            Y = bsr.matmat(X)
            path = "bsr"
        elif ell is not None:
            Y = _spmv_ops.ell_spmm(ell[0], ell[1], ell[2], X)
            path = "ell"
        elif src is not None:
            Y = _spmv_ops.csr_spmm_rowids(A.data, A.indices,
                                          src._get_row_ids(), X, rows)
            path = "csr-rowids"
        else:
            Y = _spmv_ops.csr_spmm(A.data, A.indices, A.indptr, X, rows)
            path = "csr"
        self.spmm_path = path
        return Y

    def __repr__(self) -> str:
        return (f"<{self.shape[0]}x{self.shape[1]} sparse array of type "
                f"'{self.dtype}' with {self.nnz} stored elements in "
                f"Compressed Sparse Row format on {self.device}>")


class csr_matrix(csr_array):
    """scipy's ``csr_matrix`` flavour (reference ``csr.py:1961``): ``*``
    is the matrix product, and a scalar ``*`` scales the values."""

    def __mul__(self, other):
        if np.isscalar(other) or getattr(other, "ndim", None) == 0:
            return self._with_data(self._data * other)
        return self.dot(other)

    def __rmul__(self, other):
        if np.isscalar(other) or getattr(other, "ndim", None) == 0:
            return self._with_data(self._data * other)
        return NotImplemented


def spgemm_csr_csr_csr(A: csr_array, B: csr_array) -> csr_array:
    """C = A @ B for CSR operands of one dtype on one device (reference
    ``csr.py:2050-2136``); the route goes to ``A.spgemm_path``.

    When both operands are exact bands (DIA caches without a hole
    mask) and the product band is full and within the DIA budget, C is
    the Minkowski-sum band: the banded kernel for f32/bf16
    (``"dia-kernel"``), the kernel's plain version otherwise
    (``"dia-torch"``), then ``band_to_csr``, with C's DIA cache warm.
    Everything else runs expand-sort-compress (``"esc"``)."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"dimension mismatch in spgemm: {A.shape} @ "
                         f"{B.shape}")
    m, k = A.shape
    n = B.shape[1]
    dia_a = A._get_dia()
    dia_b = B._get_dia() if dia_a is not None else None
    if (dia_a is not None and dia_b is not None and dia_a[2] is None
            and dia_b[2] is None):
        offs_c = _dia_ops.band_product_offsets(dia_a[1], dia_b[1])
        nnz_c = _dia_ops.band_cover(offs_c, (m, n), n)
        if (len(offs_c) <= settings.dia_max_diags
                and len(offs_c) * n <= settings.dia_max_expand * max(nnz_c, 1)
                # scipy's pattern: every in-bounds product slot must be
                # reachable, else ESC decides nnz.
                and _dia_ops.band_product_is_full(dia_a[1], dia_b[1], offs_c,
                                                  A.shape, B.shape)):
            if _dia_kernel.spgemm_supported(dia_a[0], dia_b[0]):
                Cd = _dia_kernel.dia_spgemm(dia_a[0], dia_b[0], dia_a[1],
                                            dia_b[1], offs_c, A.shape,
                                            B.shape)
                path = "dia-kernel"
            else:
                Cd = _dia_kernel.dia_spgemm_plain(dia_a[0], dia_b[0],
                                                  dia_a[1], dia_b[1], offs_c,
                                                  A.shape, B.shape)
                path = "dia-torch"
            data, indices, indptr = _dia_ops.band_to_csr(Cd, offs_c, (m, n),
                                                         nnz_c)
            C = csr_array._from_parts(data, indices, indptr, (m, n))
            # The product band is exact by construction: warm C's own
            # banded cache for the matvecs that follow.
            C._dia_offsets = offs_c
            C._dia = (Cd, offs_c, None)
            A.spgemm_path = path
            return C
    data, indices, indptr, _ = _spgemm_ops.spgemm_csr_csr_csr_impl(
        A.data, A.indices, A.indptr, B.data, B.indices, B.indptr, m, k, n)
    A.spgemm_path = "esc"
    return csr_array._from_parts(data, indices, indptr, (m, n))
