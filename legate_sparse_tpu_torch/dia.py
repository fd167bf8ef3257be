# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""DIA (diagonal) arrays on PyTorch tensors.

Mirrors ``legate_sparse_tpu/dia.py::dia_array``: storage is a 2-D
``data`` tensor (num_diags, width) plus the diagonals' offsets, in
scipy's column-aligned layout ``A[j - offsets[k], j] = data[k, j]``.
``tocsr`` converts sort-free (``dia.py:158``) and ``dot``
(``dia.py:224-265``) takes the same DIA kernels as ``csr_array``'s
banded path: SpMV, and SpMM for X (cols, k <= 1024); a sparse operand
goes through ``tocsr().dot``.  ``transpose`` realigns the diagonals
(``dia.py:123-142``); the rest of the scipy surface (sums, max/min,
arithmetic, comparisons) comes from ``base.py`` through CSR.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .base import CompressedBase
from .ops import dia_kernel as _dia_kernel
from .ops import dia_ops as _dia_ops
from .runtime import default_float
from .types import check_nnz, coord_dtype_for, nnz_dtype, to_torch_dtype
from .utils import as_tensor, device_of, fill_out, require_supported_dtype


class dia_array(CompressedBase):
    """Sparse matrix with DIAgonal storage, backed by a tensor."""

    format = "dia"

    def __init__(self, arg, shape=None, dtype=None, copy: bool = False,
                 device=None):
        if isinstance(arg, dia_array):
            dev = device_of(device, arg.data)
            data = arg.data.to(dev)
            offsets = arg.offsets_tuple
            shape = arg.shape if shape is None else tuple(shape)
        elif isinstance(arg, tuple) and len(arg) == 2:
            data_in, offsets_in = arg
            dev = device_of(device, data_in)
            data = as_tensor(data_in, dev)
            if data.dim() < 2:
                data = data.reshape(1, -1)
            if isinstance(offsets_in, torch.Tensor):
                offsets_in = offsets_in.cpu().numpy()
            offsets = tuple(int(o) for o in
                            np.atleast_1d(np.asarray(offsets_in)))
            if shape is None:
                raise ValueError("dia_array from (data, offsets) needs shape")
        else:
            raise NotImplementedError(
                "dia_array supports (data, offsets) or dia_array inputs")
        if dtype is not None:
            data = data.to(to_torch_dtype(dtype))
        elif data.dtype == torch.float16:
            data = data.to(default_float)
        if copy:
            data = data.clone()
        if len(offsets) != int(data.shape[0]):
            raise ValueError("number of diagonals != number of offsets")
        if len(set(offsets)) != len(offsets):
            raise ValueError("offset array contains duplicate values")
        self._data = data
        self._offsets = offsets
        self._pack = None  # cached kernel pack (False = not supported)
        self.shape: Tuple[int, int] = tuple(int(s) for s in shape)
        self.spmv_path: Optional[str] = None
        self.spmm_path: Optional[str] = None

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def offsets(self) -> torch.Tensor:
        return torch.tensor(self._offsets, dtype=torch.int64,
                            device=self._data.device)

    @property
    def offsets_tuple(self) -> Tuple[int, ...]:
        return self._offsets

    @property
    def nnz(self) -> int:
        """Stored values inside the matrix bounds (reference
        ``dia.py:90-99``)."""
        rows, cols = self.shape
        offs = np.asarray(self._offsets, dtype=np.int64)
        lengths = np.minimum(rows + np.minimum(offs, 0),
                             cols - np.maximum(offs, 0))
        return int(np.maximum(lengths, 0).sum())

    def copy(self) -> "dia_array":
        return dia_array((self._data, self._offsets), shape=self.shape,
                         copy=True)

    def _with_data(self, data, copy: bool = False) -> "dia_array":
        return type(self)((data, self._offsets), shape=self.shape,
                          copy=copy)

    def transpose(self, axes=None, copy: bool = False):
        """Diagonal k of A is diagonal -k of A.T; in scipy's
        column-aligned layout ``A.T``'s ``data[d, p]`` is A's
        ``data[d, p + offsets[d]]`` (0 where that column is outside the
        stored width)."""
        if axes is not None:
            raise ValueError("axes parameter not supported")
        rows, cols = self.shape
        num_d, width = self._data.shape
        dev = self._data.device
        offs = torch.tensor(self._offsets, dtype=torch.int64, device=dev)
        src = (torch.arange(max(rows, cols), dtype=torch.int64,
                            device=dev)[None, :] + offs[:, None])
        valid = (src >= 0) & (src < width)
        gathered = torch.where(
            valid, self._data.gather(1, src.clamp(0, max(width - 1, 0))),
            torch.zeros((), dtype=self.dtype, device=dev))
        return dia_array((gathered, tuple(-o for o in self._offsets)),
                         shape=(cols, rows))

    @property
    def T(self):
        return self.transpose()

    def todia(self, copy: bool = False) -> "dia_array":
        return self.copy() if copy else self

    def toscipy(self):
        """Host scipy ``dia_array``."""
        import scipy.sparse as sp

        from .utils import to_numpy

        return sp.dia_array((to_numpy(self._data),
                             np.asarray(self._offsets)), shape=self.shape)

    def tocsr(self, copy: bool = False):
        """DIA → CSR without a sort: with offsets ascending, a row-major
        walk of the (row, diagonal) slot grid is CSR order, so one mask
        and one compaction build the arrays.  Zeros are dropped, as
        scipy does."""
        from .csr import csr_array

        rows, cols = self.shape
        num_d, width = self._data.shape
        dev = self._data.device
        w = min(width, cols)
        cdt = coord_dtype_for(max(rows, cols) + 1)
        order = np.argsort(np.asarray(self._offsets), kind="stable")
        data = self._data
        if not np.array_equal(order, np.arange(num_d)):
            data = data[torch.as_tensor(order, device=dev)]
        offs = torch.tensor([self._offsets[k] for k in order],
                            dtype=torch.int64, device=dev)
        # data[d, col] holds A[col - off_d, col]: row i of diagonal d
        # sits at column i + off_d.
        col = torch.arange(rows, dtype=torch.int64, device=dev)[None, :] \
            + offs[:, None]
        valid = (col >= 0) & (col < width)
        vals = torch.where(
            valid, data.gather(1, col.clamp(0, max(width - 1, 0))),
            torch.zeros((), dtype=data.dtype, device=dev))
        keep = (col >= 0) & (col < w) & (vals != 0)
        idx = torch.nonzero(keep.T.reshape(-1), as_tuple=True)[0]
        check_nnz(int(idx.shape[0]))
        cdata = vals.T.reshape(-1)[idx]
        cindices = col.T.reshape(-1)[idx].to(cdt)
        counts = keep.sum(dim=0, dtype=nnz_dtype())
        cindptr = torch.zeros((rows + 1,), dtype=nnz_dtype(), device=dev)
        torch.cumsum(counts, 0, out=cindptr[1:])
        return csr_array._from_parts(cdata, cindices, cindptr, self.shape)

    # ---------------- products ----------------
    def _get_pack(self):
        """Cached kernel pack of the band (unmasked: every in-bounds
        slot of a DIA array is an entry)."""
        if self._pack is None:
            packed = _dia_kernel.pack_band(self._data, self._offsets,
                                           self.shape)
            self._pack = packed if packed is not None else False
        return self._pack if self._pack is not False else None

    def dot(self, other, out=None):
        """SpMV and SpMM through the DIA kernels when they take the band
        and the operand has the band's dtype, else the plain shifted
        adds; a sparse operand goes through CSR (SpGEMM)."""
        from .csr import _is_scipy_sparse

        require_supported_dtype(self.dtype)
        if isinstance(other, CompressedBase) or _is_scipy_sparse(other):
            return self.tocsr().dot(other)
        x = as_tensor(other, self._data.device)
        squeeze = False
        if x.dim() == 2 and x.shape[1] == 1:
            x = x.reshape(-1)
            squeeze = True
        if x.dim() not in (1, 2) or x.shape[0] != self.shape[1]:
            raise ValueError(f"dimension mismatch: {self.shape} @ "
                             f"{tuple(x.shape)}")
        if x.dim() == 2:
            k = x.shape[1]
            packed = (self._get_pack()
                      if 0 < k <= _dia_kernel.SPMM_MAX_K else None)
            if _dia_kernel.spmm_supported(packed, x):
                Y = _dia_kernel.dia_spmm(packed, x.contiguous())
                self.spmm_path = "dia-kernel"
            else:
                Y = _dia_ops.dia_spmm(self._data, x, self._offsets,
                                      self.shape)
                self.spmm_path = "dia-torch"
            return fill_out(Y, out)
        packed = self._get_pack() if x.dtype == self.dtype else None
        if packed is not None:
            y = _dia_kernel.dia_spmv(packed, x.contiguous())
            self.spmv_path = "dia-kernel"
        else:
            y = _dia_ops.dia_spmv_nopad(self._data, None, x, self._offsets,
                                        self.shape)
            self.spmv_path = "dia-torch"
        if squeeze:
            y = y[:, None]
        return fill_out(y, out)

    def todense(self) -> torch.Tensor:
        return self.tocsr().todense()

    toarray = todense

    def __repr__(self) -> str:
        return (f"<{self.shape[0]}x{self.shape[1]} sparse array of type "
                f"'{self.dtype}' with {self.nnz} stored elements "
                f"({self._data.shape[0]} diagonals) in DIAgonal format on "
                f"{self._data.device}>")


class dia_matrix(dia_array):
    """scipy's ``dia_matrix`` flavour: ``*`` and ``**`` are the matrix
    product and power."""

    _is_spmatrix = True

    def __pow__(self, n):
        from .csr import csr_matrix

        out = (csr_matrix(self.tocsr()) ** n).asformat("dia")
        out.__class__ = type(self)
        return out
