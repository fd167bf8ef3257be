# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""CSR arrays on PyTorch tensors.

Mirrors ``legate_sparse_tpu/csr.py::csr_array``: storage is three
tensors on one device — ``data`` (nnz), ``indices`` (nnz, int32 unless
an extent needs int64) and ``indptr`` (rows+1, int64).  It carries the
constructors (``(data, indices, indptr)``, COO ``(data, (row, col))``,
the empty ``(M, N)``, scipy, dense, any sparse format of this package),
the scipy surface of the JAX package's ``csr_array``: structure
maintenance (``sum_duplicates``, ``eliminate_zeros``,
``sort_indices``), element-wise arithmetic and comparisons, reductions
(from ``base.py``), indexing, ``setdiag``, conversions to COO, CSC and
DIA; the structure caches of the SpMV hot path; and ``dot``, which
dispatches by operand and structure in the JAX package's order:

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
``"ell-bf16"``,           compressed storage against an operand of
``"csr-rowids-bf16"``     another dtype: f32 products and sums (SpMV;
                          SpMM ``"csr-rowids-bf16"`` only)
``"csr"``                 the operand's dtype promoted the matrix
``"engine"``              ``settings.engine``: the shape-bucketed plan
                          (``engine/``), bit for bit ``"csr-rowids"``
a verdict's label         ``settings.autotune``: a stored verdict's
                          kernel (``autotune/``)
========================  ==============================================

A sparse operand (``csr_array``, ``dia_array``, scipy) takes SpGEMM,
``spgemm_csr_csr_csr``, labelled in ``spgemm_path``: ``"dia-kernel"``
(both operands exact bands, f32/bf16: ``csrc/dia_spgemm.cu``),
``"dia-torch"`` (exact bands, other dtypes) or ``"esc"``
(``ops/spgemm.py``).  Compressed storage (``compress``: bf16 values,
int16 indices) against an operand of another dtype takes the JAX
package's widening routes: ``"dia-torch"`` (f32 products),
``"ell-bf16"`` and ``"csr-rowids-bf16"`` (f32 accumulation); BSR and
the DIA kernels stand down there.  Ahead of the structure chain, as
in the JAX package, come the engine rung and then the autotune rung;
each declines (off, the default; a banded or block matrix; dtype
promotion) into the chain.  With ``settings.resil`` on, ``dot`` runs
under the ``csr.dot`` resilience site.  Every product counts ``op.*``
and times ``lat.*`` (``obs``).

In-place mutators (``sum_duplicates``, ``eliminate_zeros``,
``sort_indices``, ``setdiag``, ``resize``, the ``data`` setter) rebind
the tensors, never write into them (a full-slice ``A[:]`` shares
them), and clear the caches through ``_invalidate_caches``: the
structural ones only when the structure changed.  Host syncs follow the
JAX package's: one per data-dependent size.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .base import (CompressedBase, DenseSparseBase, _is_scalar, _power,
                   _scalar_dtype, _scalar_op, _extreme)
from .ops import convert as _convert
from .ops import dia_kernel as _dia_kernel
from .ops import dia_ops as _dia_ops
from .ops import spgemm as _spgemm_ops
from .ops import spmv as _spmv_ops
from .autotune import route_matmat as _autotune_route_matmat
from .autotune import route_matvec as _autotune_route_matvec
from .engine import route_matmat as _engine_route_matmat
from .engine import route_matvec as _engine_route_matvec
from .obs import counters as _obs_counters
from .obs import latency as _lat
from .obs import trace as _trace
from .resilience import faults as _rfaults
from .resilience import policy as _rpolicy
from .runtime import default_float
from .settings import settings
from .types import (SparseEfficiencyWarning, check_nnz, coord_dtype_for,
                    nnz_dtype, to_numpy_dtype, to_torch_dtype)
from .utils import (as_tensor, cast_to_common_type, device_of, fill_out,
                    find_common_type, is_sparse_matrix,
                    require_supported_dtype, result_type, to_host, to_inexact,
                    to_numpy, true_divide_type)


def _row_dtype(index_dtype: torch.dtype) -> torch.dtype:
    """Dtype for row ids beside column indices of ``index_dtype``: the
    same, but at least int32, since compressed storage's int16 column
    indices say nothing of the row count (the JAX package casts row ids
    to int16 too, and wraps them past 32,767 rows)."""
    return torch.promote_types(index_dtype, torch.int32)


def _is_scipy_sparse(obj) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover
        return False
    return sp.issparse(obj)


def _is_sparse_like(obj) -> bool:
    """A sparse matrix of this package or of another library (it has a
    CSR conversion and is not array-like)."""
    return hasattr(obj, "tocsr") and not hasattr(obj, "__array__")


def _probed(sp, fmt: str, declined: bool, **count) -> None:
    """The verdict of a structure probe (the first ``_get_dia``,
    ``_get_bsr`` or ``_get_ell`` of a matrix): a decline counts in
    ``dispatch.declined.<fmt>``; while tracing is on, the probe's
    ``dispatch.probe`` span takes it and the count that decided it."""
    if declined:
        _obs_counters.handle("dispatch.declined." + fmt).inc()
    if sp is not None:
        sp.set(declined=declined, **count)


# Comparison operators: the torch op for stored values, the numpy op
# for the implicit-zero test and dense results (the JAX package applies
# one ``jnp`` function to both).
_COMPARE = {
    "eq": (torch.eq, np.equal), "ne": (torch.ne, np.not_equal),
    "lt": (torch.lt, np.less), "gt": (torch.gt, np.greater),
    "le": (torch.le, np.less_equal), "ge": (torch.ge, np.greater_equal),
}


class csr_array(CompressedBase, DenseSparseBase):
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
        if is_sparse_matrix(arg) and not isinstance(arg, csr_array):
            arg = arg.tocsr()
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
            # The JAX package's pow2-bucketed COO-build counter
            # (``csr.py:158``): repeated same-bucket rebuilds show a
            # workload paying for full CSR reconstruction.
            _obs_counters.inc(
                "build.csr.coo."
                f"{1 << max(shape[0] - 1, 0).bit_length()}x"
                f"{1 << max(shape[1] - 1, 0).bit_length()}")
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
        self._sorted = True if canonical else None
        self.shape: Tuple[int, int] = tuple(int(s) for s in shape)
        if self._indptr.shape[0] != self.shape[0] + 1:
            raise ValueError(f"indptr length {self._indptr.shape[0]} != "
                             f"rows+1 ({self.shape[0] + 1})")
        # Static-structure caches of the SpMV hot path, built lazily on
        # the first matvec (False = tried, not applicable).
        self._row_ids = None
        self._row_lengths = None
        self._ell = None
        self._ell_width = None
        self._dia = None
        self._dia_offsets = None
        self._dia_pack = None
        self._bsr = None
        self._sliced_ell = None
        # The engine's bucket-padded operands ((terms, pack), engine/
        # core.py) and the autotuner's structure fingerprint.
        self._engine_pack = None
        self._fingerprint = None
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

    def _with_data(self, data, copy: bool = False) -> "csr_array":
        """Same structure, new values (structure caches shared)."""
        if copy:
            data = data.clone()
        out = type(self)._from_parts(data, self._indices, self._indptr,
                                     self.shape, canonical=self._canonical)
        out._row_ids = self._row_ids
        out._row_lengths = self._row_lengths
        out._ell_width = self._ell_width
        out._dia_offsets = self._dia_offsets
        out._fingerprint = self._fingerprint
        out._sorted = self._sorted
        return out

    def copy(self) -> "csr_array":
        return type(self)(self, copy=True)

    # ---------------- properties ----------------
    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        return int(self._data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @data.setter
    def data(self, value):
        value = as_tensor(value, self.device)
        if tuple(value.shape) != tuple(self._data.shape):
            raise ValueError("cannot change nnz via data setter")
        self._data = value
        self._invalidate_caches(structure_changed=False)

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

    @property
    def has_sorted_indices(self) -> bool:
        """Non-decreasing indices within every row (duplicates allowed:
        weaker than canonical; scipy's ``has_sorted_indices``)."""
        if self._canonical:
            return True
        if self._sorted is None:
            if self.nnz < 2:
                self._sorted = True
            else:
                row_ids = self._get_row_ids()
                same_row = row_ids[1:] == row_ids[:-1]
                nondecreasing = self._indices[1:] >= self._indices[:-1]
                self._sorted = bool(torch.all(~same_row | nondecreasing))
        return self._sorted

    def sum_duplicates(self) -> None:
        """Merge duplicate (row, col) entries in place (scipy's contract:
        returns None).  Sorted by the fused key ``row * cols + col``;
        the duplicates of one coordinate are summed in their stored
        order (the JAX package's sort is unstable there)."""
        if self.has_canonical_format:
            return
        row_ids, cols, vals = self._coo_parts()
        data, indices, indptr = _spgemm_ops.coalesce_coo(
            row_ids.to(torch.int64), cols.to(torch.int64), vals,
            self.shape[0], self.shape[1])
        self._data = data
        self._indices = indices.to(self._indices.dtype)
        self._indptr = indptr
        self._invalidate_caches(structure_changed=True)
        self._canonical = True
        self._sorted = True

    def _canonicalized(self) -> "csr_array":
        if self.has_canonical_format:
            return self
        out = csr_array(self, copy=False)
        out.sum_duplicates()
        return out

    # ---------------- storage compression ----------------
    def compress(self, values="bfloat16", indices="auto",
                 copy: bool = False) -> "csr_array":
        """Narrow the storage (reference ``csr.py:389-450``): values to
        ``values`` (default bf16; None keeps them; any supported dtype,
        so ``astype_storage`` can widen back) and column indices to
        ``indices``: ``"auto"`` (int16 when the column extent fits it,
        else kept), None (kept) or a signed integer dtype, which raises
        when the column extent overflows it.

        ``.dtype`` reports the storage dtype, while ``dot`` keeps f32
        semantics: compressed values against an operand of another
        dtype whose result type is f32 take the f32-accumulation paths
        (``"ell-bf16"``, ``"csr-rowids-bf16"``, the DIA shifted adds
        with f32 products) without a widened copy of the matrix.  The
        structure caches that do not depend on the index dtype are
        shared (``_with_data``); the value packs rebuild lazily.

        Declared IEEE trade, as in the JAX package: bf16 storage drops
        the DIA hole mask (the band is zero-filled), so a non-finite x
        entry at a band hole gives NaN where f32 storage masks it."""
        data = self._data
        if values is not None:
            vdt = to_torch_dtype(values)
            require_supported_dtype(vdt)
            if vdt != data.dtype:
                data = data.to(vdt)
        idx = self._indices
        if indices is not None:
            if isinstance(indices, str) and indices == "auto":
                idt = (torch.int16
                       if self.shape[1] - 1 <= torch.iinfo(torch.int16).max
                       else None)
            else:
                idt = to_torch_dtype(indices)
                if idt not in (torch.int8, torch.int16, torch.int32,
                               torch.int64):
                    raise ValueError(
                        f"index storage must be a signed integer dtype, "
                        f"got {idt}")
                if self.shape[1] - 1 > torch.iinfo(idt).max:
                    raise ValueError(
                        f"column extent {self.shape[1]} overflows index "
                        f"dtype {idt}")
            if idt is not None and idt != idx.dtype:
                idx = idx.to(idt)
            elif copy:
                idx = idx.clone()
        out = self._with_data(data, copy=copy and data is self._data)
        out._indices = idx
        return out

    def astype_storage(self, values=None, indices=None,
                       copy: bool = False) -> "csr_array":
        """``compress`` with keep-by-default arguments: changes how the
        bytes are stored, where ``astype`` changes the logical dtype."""
        return self.compress(values=values, indices=indices, copy=copy)

    def _invalidate_caches(self, structure_changed: bool) -> None:
        """Drop the caches an in-place mutation made stale (reference
        ``csr.py:1654-1671``).  With ``structure_changed`` False only the
        value-derived ones go (the band and its kernel pack, the ELL
        and sliced-ELL packs, the BSR structure, which refers to the old
        tensors)."""
        self._ell = None
        self._dia = None
        self._dia_pack = None
        self._bsr = None
        self._sliced_ell = None
        self._engine_pack = None
        if structure_changed:
            self._row_ids = None
            self._row_lengths = None
            self._fingerprint = None
            self._ell_width = None
            self._dia_offsets = None
            self._canonical = None
            self._sorted = None

    # ---------------- conversions ----------------
    def todense(self, order=None, out=None) -> torch.Tensor:
        if order is not None:
            raise NotImplementedError("order parameter is not supported")
        return fill_out(_convert.csr_to_dense(self._data, self._indices,
                                              self._indptr, self.shape), out)

    toarray = todense

    def tocsr(self, copy: bool = False) -> "csr_array":
        return self.copy() if copy else self

    def toscipy(self):
        """Host scipy ``csr_array`` (bf16 values widen to float32)."""
        import scipy.sparse as sp

        return sp.csr_array((to_numpy(self._data), to_numpy(self._indices),
                             to_numpy(self._indptr)), shape=self.shape)

    def _coo_parts(self):
        """(row, col, data) coordinate view (row ids in the indices'
        dtype, at least int32: ``_row_dtype``); the public ``tocoo``
        returns a ``coo_array``."""
        return (self._get_row_ids().to(_row_dtype(self._indices.dtype)),
                self._indices, self._data)

    def tocoo(self, copy: bool = False):
        from .coo import coo_array

        return coo_array(self)

    def tocsc(self, copy: bool = False):
        from .csc import csc_array

        return csc_array(self)

    def todia(self, copy: bool = False):
        """``dia_array`` of every distinct ``col - row`` (scipy's
        ``todia``), through the banded path's ``csr_band_offsets`` and
        ``dia_from_csr``."""
        from .dia import dia_array

        a = self._canonicalized()
        rows, cols = self.shape
        if a.nnz == 0:
            return dia_array((torch.zeros((0, 0), dtype=self.dtype,
                                          device=self.device), ()),
                             shape=self.shape)
        offsets = _dia_ops.csr_band_offsets(a._indices, a._get_row_ids(),
                                            max(rows + cols, 1))
        dia_data = _dia_ops.dia_from_csr(a._data, a._indices,
                                         a._get_row_ids(), offsets, cols)
        return dia_array((dia_data, offsets), shape=self.shape)

    def asformat(self, format, copy: bool = False):
        """This matrix in ``format`` ('csr', 'csc', 'coo', 'dia')."""
        if format is None or format == "csr":
            return self.tocsr(copy=copy)
        if format in ("dia", "csc", "coo"):
            return getattr(self, "to" + format)(copy=copy)
        raise ValueError(f"unsupported format: {format!r}")

    def todok(self, copy: bool = False):
        """scipy's DOK matrix, on the host (no DOK type here)."""
        return self.toscipy().todok(copy=copy)

    def tolil(self, copy: bool = False):
        """scipy's LIL matrix, on the host (no LIL type here)."""
        return self.toscipy().tolil(copy=copy)

    # ---------------- structure maintenance ----------------
    def getnnz(self, axis=None):
        """nnz, or the stored entries per row (``axis=1``) or per column
        (``axis=0``): int64 tensors."""
        if axis is None:
            return self.nnz
        if axis in (1, -1):
            return self._indptr[1:] - self._indptr[:-1]
        if axis == 0:
            return torch.bincount(self._indices.to(torch.int64),
                                  minlength=self.shape[1])
        raise ValueError(f"invalid axis: {axis}")

    def eliminate_zeros(self) -> None:
        """Drop the stored zeros in place (one host sync: the count)."""
        keep = torch.nonzero(self._data != 0).reshape(-1)
        if keep.shape[0] == self.nnz:
            return
        new_rows = self._get_row_ids()[keep]
        self._data = self._data[keep]
        self._indices = self._indices[keep]
        self._indptr = _convert.indptr_from_row_ids(new_rows, self.shape[0])
        canonical, srt = self._canonical, self._sorted
        self._invalidate_caches(structure_changed=True)
        # Dropping entries keeps a row sorted and free of duplicates.
        self._canonical, self._sorted = canonical, srt

    def sort_indices(self) -> None:
        """Sort the column indices of every row in place, stably, without
        merging duplicates (scipy's ``sort_indices``)."""
        if self.has_sorted_indices:
            return
        key = (self._get_row_ids().to(torch.int64) * max(self.shape[1], 1)
               + self._indices.to(torch.int64))
        order = torch.argsort(key, stable=True)
        self._data = self._data[order]
        self._indices = self._indices[order]
        self._invalidate_caches(structure_changed=True)
        self._sorted = True

    def resize(self, *shape) -> None:
        """Resize in place; entries outside the new shape are dropped
        (scipy's ``resize``)."""
        if len(shape) == 1:
            shape = tuple(shape[0])
        nr, nc = int(shape[0]), int(shape[1])
        r, c, v = self._coo_parts()
        r2, c2, v2 = _convert.compact_mask((r < nr) & (c < nc), (r, c, v))
        new = csr_array((v2, (r2, c2)), shape=(nr, nc), device=self.device)
        self._data, self._indices, self._indptr = (new._data, new._indices,
                                                   new._indptr)
        self.shape = (nr, nc)
        self._invalidate_caches(structure_changed=True)

    def reshape(self, *shape, order="C"):
        """Reshape through scipy on the host; 2-D targets only (there is
        no 1-D sparse type here)."""
        if len(shape) == 1:
            if isinstance(shape[0], (int, np.integer)):
                raise ValueError(
                    "1-D reshape targets are not supported (no 1-D sparse "
                    "type); pass a 2-D shape")
            shape = tuple(shape[0])
        if len(shape) != 2:
            raise ValueError(f"expected a 2-D shape, got {shape}")
        return csr_array(self.toscipy().reshape(shape, order=order).tocsr(),
                         device=self.device)

    def argmax(self, axis=None, out=None):
        """Index of the maximum, implicit zeros included: scipy on the
        host (its tie-breaking exactly)."""
        return self.toscipy().argmax(axis=axis, out=out)

    def argmin(self, axis=None, out=None):
        return self.toscipy().argmin(axis=axis, out=out)

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

    def conj(self, copy: bool = True):
        if self.dtype.is_complex:
            return self._with_data(torch.conj_physical(self._data))
        return self.copy() if copy else self

    conjugate = conj

    def trace(self, offset: int = 0):
        """Sum along diagonal ``offset`` (a 0-d tensor)."""
        return torch.sum(self.diagonal(offset))

    def count_nonzero(self, axis=None):
        """Entries whose value is nonzero after duplicates are merged:
        an int, or an int32 numpy array per column (``axis=0``) or row
        (``axis=1``)."""
        a = self._canonicalized()
        nz = (a._data != 0).to(torch.int32)
        if axis is None:
            return int(torch.sum(nz))
        if axis not in (0, 1, -1, -2):
            raise ValueError(f"invalid axis {axis}")
        if int(axis) % 2 == 0:
            counts = torch.zeros((a.shape[1],), dtype=torch.int32,
                                 device=a.device)
            counts.index_add_(0, a._indices.to(torch.int64), nz)
            return to_numpy(counts)
        return to_numpy(_convert.segment_sum(
            nz, a._indptr[1:] - a._indptr[:-1]))

    # ---------------- arithmetic ----------------
    def power(self, n, dtype=None):
        """Element-wise power of the merged entries (scipy sums
        duplicates first)."""
        a = self._canonicalized()
        data = a._data
        if dtype is not None:
            data = data.to(to_torch_dtype(dtype))
        return a._with_data(_power(data, n))

    def _minmax_binary(self, other, name: str):
        """Element-wise maximum/minimum with a scalar or a sparse operand
        over the union of the structures, implicit zeros included
        (scipy's ``maximum``/``minimum``)."""
        def op(a, b):
            return _extreme(a, b, name)

        if _is_scalar(other):
            dt, other = _scalar_dtype(self.dtype, other)
            s = torch.tensor(other, dtype=dt, device=self.device)
            fill = op(torch.zeros((), dtype=dt, device=self.device), s)
            if bool(fill != 0):
                warnings.warn(
                    "Taking maximum/minimum with a scalar that is nonzero "
                    "against the zero fill produces a dense result",
                    SparseEfficiencyWarning, stacklevel=3)
                return csr_array(op(self.toarray().to(dt), s))
            a = self._canonicalized()   # op distributes over values,
            return a._with_data(op(a._data.to(dt), s))  # not duplicates
        other = self._sparse_operand(other, dense_ok=True)
        if other.shape != self.shape:
            raise ValueError("inconsistent shapes")
        a, b = cast_to_common_type(self._canonicalized(),
                                   other._canonicalized())
        rows, cols = a.shape
        ra, ca, va = a._coo_parts()
        rb, cb, vb = b._coo_parts()
        # The union: a key on one side only meets its implicit zero.
        row = torch.cat([ra, rb])
        col = torch.cat([ca, cb])
        key = row.to(torch.int64) * max(cols, 1) + col.to(torch.int64)
        val = torch.cat([va, vb])
        order = torch.argsort(key, stable=True)
        key = key[order]
        val = val[order]
        none = torch.full((1,), -1, dtype=key.dtype, device=key.device)
        nxt = torch.cat([key[1:], none])
        prv = torch.cat([none, key[:-1]])
        zeros = torch.zeros_like(val)
        pair_val = torch.where(key == nxt, op(val, torch.roll(val, -1)),
                               zeros)
        out_val = torch.where((key == nxt) | (key == prv), pair_val,
                              op(val, zeros))
        out = csr_array((out_val, (row[order], col[order])),
                        shape=self.shape)
        out.sum_duplicates()   # merges the zeroed slot of each pair
        out.eliminate_zeros()
        return out

    def maximum(self, other):
        return self._minmax_binary(other, "max")

    def minimum(self, other):
        return self._minmax_binary(other, "min")

    def _sparse_operand(self, other, dense_ok: bool = False):
        """``other`` as a ``csr_array`` on this matrix's device: scipy
        and the other formats convert; a dense operand only with
        ``dense_ok``, else None."""
        if _is_scipy_sparse(other):
            return csr_array(other, device=self.device)
        if not isinstance(other, csr_array) and _is_sparse_like(other):
            other = other.tocsr()
        if isinstance(other, csr_array):
            if other.device != self.device:
                other = csr_array(other, device=self.device)
            return other
        if dense_ok:
            return csr_array(as_tensor(other, self.device))
        return None

    def multiply(self, other):
        """Element-wise product with a scalar, a dense matrix, row or
        column vector (scipy's broadcasting, no densifying), or any
        sparse operand (the intersection of the patterns)."""
        if _is_scalar(other):
            return self._with_data(_scalar_op(self._data, other, torch.mul))
        sparse_other = self._sparse_operand(other)
        if sparse_other is not None:
            if sparse_other.shape != self.shape:
                raise ValueError("inconsistent shapes for multiply")
            a, b = cast_to_common_type(self._canonicalized(),
                                       sparse_other._canonicalized())
            return _elementwise_intersect_multiply(a, b)
        other = as_tensor(other, self.device)
        dt = result_type(self.dtype, other.dtype)
        rows, cols = self.shape
        if other.dim() == 2 and tuple(other.shape) == self.shape:
            pick = other[self._get_row_ids(), self._indices.to(torch.int64)]
        elif other.dim() == 1 and other.shape[0] == cols:
            pick = other[self._indices.to(torch.int64)]
        elif other.dim() == 2 and tuple(other.shape) == (1, cols):
            pick = other[0, self._indices.to(torch.int64)]
        elif other.dim() == 2 and tuple(other.shape) == (rows, 1):
            pick = other[self._get_row_ids(), 0]
        else:
            raise ValueError(f"inconsistent shapes for multiply: "
                             f"{tuple(other.shape)}")
        return self._with_data(self._data.to(dt) * pick.to(dt))

    def __mul__(self, other):
        if _is_scalar(other):
            return self._with_data(_scalar_op(self._data, other, torch.mul))
        # sparray semantics: ``*`` is element-wise (csr_matrix overrides).
        return self.multiply(other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        if _is_scalar(other):
            return self._with_data(_scalar_op(self._data, other, torch.div,
                                              true_divide_type))
        if _is_scipy_sparse(other) or _is_sparse_like(other):
            if tuple(other.shape) != self.shape:
                raise ValueError(f"inconsistent shapes {self.shape} and "
                                 f"{tuple(other.shape)}")
            # scipy: sparse / sparse is dense (0/0 gives nan).
            a = self.toarray()
            b = as_tensor(other.toarray(), self.device)
            dt = to_inexact(torch.promote_types(a.dtype, b.dtype))
            return a.to(dt) / b.to(dt)
        # A dense divisor divides the stored entries only (the implicit
        # zeros stay zero, a sparse result as in scipy); row and column
        # vectors broadcast.
        other = as_tensor(other, self.device)
        recip = 1.0 / other.to(true_divide_type(other.dtype, 1.0))
        if recip.dim() == 2 and tuple(recip.shape) != self.shape:
            recip = torch.broadcast_to(recip, self.shape)
        return self.multiply(recip)

    def __neg__(self):
        return self._with_data(-self._data)

    def __abs__(self):
        if self.dtype == torch.bool:
            return self._with_data(self._data.clone())
        return self._with_data(torch.abs(self._data))

    def __pow__(self, n):
        if np.isscalar(n) and n == 0:
            raise NotImplementedError(
                "zero power is not supported as it would densify the "
                "matrix; use np.ones(A.shape, dtype=A.dtype)")
        return self.power(n)

    def _add_sub(self, other, sign: int):
        if not isinstance(other, csr_array):
            if np.isscalar(other) and other == 0:
                return self.copy()   # sum() and accumulations start at 0
            other = self._sparse_operand(other)
            if other is None:
                raise NotImplementedError(
                    "sparse +/- dense is not supported; densify explicitly")
        elif other.device != self.device:
            other = csr_array(other, device=self.device)
        if other.shape != self.shape:
            raise ValueError("inconsistent shapes")
        a, b = cast_to_common_type(self, other)
        rows, cols = self.shape
        ra, ca, va = a._coo_parts()
        rb, cb, vb = b._coo_parts()
        row = torch.cat([ra, rb]).to(torch.int64)
        col = torch.cat([ca, cb]).to(torch.int64)
        val = torch.cat([va, _scalar_op(vb, sign, torch.mul)])
        data, indices, indptr = _spgemm_ops.coalesce_coo(row, col, val,
                                                         rows, cols)
        return type(self)._from_parts(data, indices, indptr, self.shape)

    def __add__(self, other):
        return self._add_sub(other, 1)

    def __sub__(self, other):
        return self._add_sub(other, -1)

    # ---------------- comparisons ----------------
    def _compare(self, other, name: str):
        """Element-wise comparison, scipy's semantics: a bool sparse
        array of the True positions, or a dense bool numpy array for a
        dense operand.  Where the op is True at the implicit zeros
        (``0 == 0``) the result is dense-shaped: it warns and is built
        from a dense comparison, as in scipy."""
        top, nop = _COMPARE[name]
        cls = type(self)
        scalar = _is_scalar(other)
        sparse_other = _is_scipy_sparse(other) or _is_sparse_like(other)
        if sparse_other and tuple(other.shape) != self.shape:
            raise ValueError("inconsistent shapes")
        if not scalar and not sparse_other:
            return nop(to_numpy(self.toarray()), to_host(other))
        if scalar:
            dt, other = _scalar_dtype(self.dtype, other)
        fill_true = bool(nop(0, other if scalar else 0))
        if fill_true:
            warnings.warn(
                "Comparing a sparse array using a comparison that is True "
                "for implicit zeros is inefficient (dense-shaped result)",
                SparseEfficiencyWarning, stacklevel=3)
        if scalar:
            if fill_true:
                return cls(top(self.toarray(), other))
            a = self._canonicalized()
            out = cls(a._with_data(top(a._data.to(dt), other)))
            out.eliminate_zeros()
            return out
        if fill_true:
            return cls(top(self.toarray(),
                           as_tensor(other.toarray(), self.device)))
        return self._compare_sparse_union(other, top)

    def _compare_sparse_union(self, other, op):
        """``op`` over the union of two sparse operands' structures, with
        no dense intermediate: one stable sort by (row, col), one value
        channel per operand."""
        other = self._sparse_operand(other)
        a, b = self._canonicalized(), other._canonicalized()
        rows, cols = a.shape
        ra, ca, va = a._coo_parts()
        rb, cb, vb = b._coo_parts()
        row = torch.cat([ra, rb])
        col = torch.cat([ca, cb])
        cha = torch.cat([va, torch.zeros_like(vb)])
        chb = torch.cat([torch.zeros_like(va), vb])
        key = row.to(torch.int64) * max(cols, 1) + col.to(torch.int64)
        order = torch.argsort(key, stable=True)
        key, row, col, cha, chb = (t[order] for t in (key, row, col, cha,
                                                      chb))
        same = key[1:] == key[:-1]
        no = torch.zeros((1,), dtype=torch.bool, device=key.device)
        same_next = torch.cat([same, no])
        first = ~torch.cat([no, same])
        # Merge each pair's channels onto the first slot of its key.
        va_m = cha + torch.where(same_next, torch.roll(cha, -1),
                                 torch.zeros_like(cha))
        vb_m = chb + torch.where(same_next, torch.roll(chb, -1),
                                 torch.zeros_like(chb))
        res = first & op(va_m, vb_m)
        out = type(self)((res, (row, col)), shape=self.shape)
        out.eliminate_zeros()
        return out

    def __eq__(self, other):
        return self._compare(other, "eq")

    def __ne__(self, other):
        return self._compare(other, "ne")

    def __lt__(self, other):
        return self._compare(other, "lt")

    def __gt__(self, other):
        return self._compare(other, "gt")

    def __le__(self, other):
        return self._compare(other, "le")

    def __ge__(self, other):
        return self._compare(other, "ge")

    # Defining __eq__ clears the hash: sparse arrays are mutable and
    # unhashable, as scipy's are.
    __hash__ = None

    def nonzero(self):
        """(row, col) numpy arrays of the nonzero entries."""
        from .gallery import find

        r, c, _ = find(self)
        return r, c

    # ---------------- mutation and indexing ----------------
    def setdiag(self, values, k: int = 0) -> None:
        """Set diagonal ``k`` in place (scipy's ``setdiag``).  Stored
        entries on it are overwritten; rows with no stored entry there
        get one, sorted into their column order (as scipy does; the JAX
        package appends them at the row's end), so a canonical matrix
        stays canonical and keeps its banded path.  One host sync: the
        count of the rows that need an entry."""
        rows, cols = self.shape
        if k <= -rows or k >= cols:
            raise ValueError("k exceeds matrix dimensions")
        length = min(rows + min(k, 0), cols - max(k, 0))
        vals = as_tensor(values, self.device, dtype=self.dtype)
        if vals.dim() == 0:
            vals = vals.expand(length)
        length = min(length, int(vals.shape[0]))
        vals = vals[:length]
        if length <= 0:
            return
        if self.nnz and not self.has_canonical_format:
            self.sum_duplicates()
        i0 = max(0, -k)
        row_ids = self._get_row_ids().to(torch.int64)
        on_diag = ((self._indices.to(torch.int64) - row_ids == k)
                   & (row_ids < i0 + length))
        rel = torch.clamp(row_ids - i0, 0, length - 1)
        new_data = torch.where(on_diag, vals[rel], self._data)
        has = torch.zeros((length,), dtype=torch.bool, device=self.device)
        has[rel[on_diag]] = True
        missing = torch.nonzero(~has).reshape(-1)
        if missing.numel() == 0:
            self._data = new_data
            self._invalidate_caches(structure_changed=False)
            return
        r, c, _ = self._coo_parts()
        row = torch.cat([r.to(torch.int64), missing + i0])
        col = torch.cat([c.to(torch.int64), missing + i0 + k])
        key = row * max(cols, 1) + col
        order = torch.argsort(key, stable=True)
        self._data = torch.cat([new_data, vals[missing]])[order]
        self._indices = col[order].to(coord_dtype_for(max(self.shape)))
        self._indptr = _convert.indptr_from_row_ids(row[order], rows)
        self._invalidate_caches(structure_changed=True)
        self._canonical = True
        self._sorted = True

    def _pointwise_get(self, rows_idx, cols_pt):
        """``A[rows, cols]`` for index arrays of one shape, element by
        element (duplicates summed), as a numpy array: three host
        transfers, then numpy binary searches."""
        n_rows, n_cols = self.shape
        out_shape = rows_idx.shape
        rows_idx = np.where(rows_idx < 0, rows_idx + n_rows,
                            rows_idx).ravel()
        cols_pt = np.where(cols_pt < 0, cols_pt + n_cols, cols_pt).ravel()
        if rows_idx.size and (rows_idx.min() < 0 or rows_idx.max() >= n_rows
                              or cols_pt.min() < 0
                              or cols_pt.max() >= n_cols):
            raise IndexError("pointwise index out of range")
        indptr = to_numpy(self._indptr)
        indices = to_numpy(self._indices)
        data = to_numpy(self._data)
        np_dtype = to_numpy_dtype(self.dtype)
        if rows_idx.shape[0] <= 64:
            # A few queries: probe each row alone, not a key over all nnz.
            out = np.zeros(rows_idx.shape[0], dtype=np_dtype)
            sorted_rows = bool(self.has_sorted_indices)
            for t, (i, j) in enumerate(zip(rows_idx, cols_pt)):
                lo, hi = int(indptr[i]), int(indptr[i + 1])
                seg = indices[lo:hi]
                if sorted_rows:
                    a = np.searchsorted(seg, j, "left")
                    b = np.searchsorted(seg, j, "right")
                    out[t] = data[lo + a: lo + b].sum()
                else:
                    out[t] = data[lo:hi][seg == j].sum()
            return out.reshape(out_shape)
        row_ids = np.repeat(np.arange(n_rows, dtype=np.int64),
                            np.diff(indptr))
        key = row_ids * np.int64(n_cols) + indices.astype(np.int64)
        if not self.has_sorted_indices:
            order = np.argsort(key, kind="stable")
            key = key[order]
            data = data[order]
        q = (rows_idx.astype(np.int64) * np.int64(n_cols)
             + cols_pt.astype(np.int64))
        a = np.searchsorted(key, q, "left")
        b = np.searchsorted(key, q, "right")
        out = np.zeros(q.shape[0], dtype=np_dtype)
        single = (b - a) == 1
        out[single] = data[a[single]]
        for t in np.nonzero(b - a > 1)[0]:
            out[t] = data[a[t]: b[t]].sum()
        return out.reshape(out_shape)

    def _select_rows(self, rows_idx) -> "csr_array":
        rows_idx = np.asarray(rows_idx, dtype=np.int64)
        if rows_idx.ndim != 1:
            raise IndexError("row index arrays must be 1-D")
        n_rows = self.shape[0]
        if rows_idx.size and (rows_idx.min() < -n_rows
                              or rows_idx.max() >= n_rows):
            raise IndexError("row index out of range")
        rows_idx = np.where(rows_idx < 0, rows_idx + n_rows, rows_idx)
        idx = torch.from_numpy(rows_idx).to(self.device)
        nnz_out = int(torch.sum(self._indptr[idx + 1] - self._indptr[idx]))
        data, indices, indptr = _convert.select_rows(
            self._data, self._indices, self._indptr, idx, nnz_out)
        return csr_array._from_parts(data, indices, indptr,
                                     (len(rows_idx), self.shape[1]),
                                     canonical=self._canonical)

    @staticmethod
    def _checked_index(i: int, extent: int, axis: str) -> int:
        if not -extent <= i < extent:
            raise IndexError(f"{axis} index {i} out of range for extent "
                             f"{extent}")
        return i + extent if i < 0 else i

    @staticmethod
    def _bool_mask_to_idx(mask, extent: int, axis: str):
        if mask.shape[0] != extent:
            raise IndexError(f"boolean {axis} mask length {mask.shape[0]} "
                             f"!= {extent}")
        return np.nonzero(mask)[0]

    def __getitem__(self, key):
        """Row selection and element access (the JAX package's subset):

        - ``A[i]``/``A[i, :]``: a (1, cols) CSR row (2-D, as scipy's
          ``csr_matrix``; there is no 1-D sparse type here);
        - ``A[i, j]``: a numpy scalar, the sum of duplicates there;
        - ``A[i0:i1:step]``, ``A[row_array]``, ``A[bool_mask]``: rows;
        - a column slice, index or array after any of them; two index
          arrays of one shape pick single elements (a numpy array).
        """
        col_key = None
        if isinstance(key, tuple):
            if len(key) != 2:
                raise IndexError("too many indices for 2-D sparse array")
            key, col_key = key
        if (col_key is not None and isinstance(key, (int, np.integer))
                and isinstance(col_key, (int, np.integer))):
            i = self._checked_index(int(key), self.shape[0], "row")
            j = self._checked_index(int(col_key), self.shape[1], "column")
            lo, hi = self._indptr[i:i + 2].tolist()
            seg = to_numpy(self._indices[lo:hi])
            vals = to_numpy(self._data[lo:hi])
            return to_numpy_dtype(self.dtype).type(vals[seg == j].sum())

        if isinstance(key, slice):
            rows_idx = np.arange(*key.indices(self.shape[0]))
            full_rows = key == slice(None)
        elif isinstance(key, (int, np.integer)):
            rows_idx = np.asarray([int(key)])
            full_rows = False
        else:
            rows_idx = to_host(key)
            if rows_idx.dtype == bool:
                rows_idx = self._bool_mask_to_idx(rows_idx, self.shape[0],
                                                  "row")
            full_rows = False
            # Two index arrays pick single elements (numpy and scipy),
            # not the outer-product submatrix.
            if (col_key is not None
                    and not isinstance(col_key, (slice, int, np.integer))):
                cols_pt = to_host(col_key)
                if cols_pt.dtype == bool:
                    cols_pt = self._bool_mask_to_idx(cols_pt, self.shape[1],
                                                     "column")
                if rows_idx.shape != cols_pt.shape:
                    raise IndexError("pointwise row/column index arrays "
                                     "must have the same shape")
                return self._pointwise_get(rows_idx, cols_pt)

        # A full row slice is a new wrapper over the same tensors (the
        # mutators rebind, never write into them).
        out = (self._with_data(self._data) if full_rows
               else self._select_rows(rows_idx))
        if col_key is None or (isinstance(col_key, slice)
                               and col_key == slice(None)):
            return out
        # Column arrays may repeat or reorder columns: through the
        # transpose and row selection.  Slices and single columns take a
        # mask, a compaction and a rebase.
        if not isinstance(col_key, (slice, int, np.integer)):
            cols_sel = to_host(col_key)
            if cols_sel.dtype == bool:
                cols_sel = self._bool_mask_to_idx(cols_sel, self.shape[1],
                                                  "column")
            return out.transpose()._select_rows(cols_sel).transpose()
        if isinstance(col_key, slice):
            cols_sel = np.arange(*col_key.indices(self.shape[1]))
        else:
            cols_sel = np.asarray([self._checked_index(
                int(col_key), self.shape[1], "column")])
        remap = np.full(self.shape[1], -1, dtype=np.int64)
        remap[cols_sel] = np.arange(len(cols_sel))
        new_cols = torch.from_numpy(remap).to(self.device)[
            out.indices.to(torch.int64)]
        data, cols2, rows_kept = _convert.compact_mask(
            new_cols >= 0, (out.data, new_cols, out._get_row_ids()))
        return csr_array._from_parts(
            data, cols2.to(coord_dtype_for(max(len(cols_sel), 1))),
            _convert.indptr_from_row_ids(rows_kept, out.shape[0]),
            (out.shape[0], len(cols_sel)), canonical=None)

    # ---------------- cached matvec structure ----------------
    def _get_row_ids(self) -> torch.Tensor:
        if self._row_ids is None:
            self._row_ids = _convert.row_ids_from_indptr(self._indptr,
                                                         self.nnz)
        return self._row_ids

    def _get_row_lengths(self) -> torch.Tensor:
        """Cached stored entries per row (``indptr[1:] - indptr[:-1]``),
        the segment lengths of the csr-rowids sums: taken from indptr on
        the device, with no host sync."""
        if self._row_lengths is None:
            self._row_lengths = self._indptr[1:] - self._indptr[:-1]
        return self._row_lengths

    def _get_fingerprint(self):
        """Cached sparsity fingerprint (``autotune.Fingerprint``)."""
        if self._fingerprint is None:
            from .autotune import compute_fingerprint

            self._fingerprint = compute_fingerprint(self)
        return self._fingerprint

    def _get_ell_width(self) -> int:
        """Cached length of the longest row (at least 1): one host
        sync."""
        if self._ell_width is None:
            self._ell_width = (
                max(int((self._indptr[1:] - self._indptr[:-1]).max()), 1)
                if self.shape[0] and self.nnz else 1)
        return self._ell_width

    def _serial_rows(self) -> bool:
        """The csr-rowids summation order (``ops.spmv.row_sums``): one
        thread a row unless a row holds more than ``SERIAL_MAX_ROW``."""
        return self._get_ell_width() <= _spmv_ops.SERIAL_MAX_ROW

    def _get_ell(self):
        """Cached ELL pack, or None (padding over budget)."""
        if self._ell is not None:
            return self._ell if self._ell is not False else None
        rows = self.shape[0]
        with _trace.span("dispatch.probe", format="ell") as sp:
            W = self._get_ell_width()
            fits = _spmv_ops.ell_within_budget(rows, W, self.nnz,
                                               settings.ell_max_expand)
            self._ell = (_spmv_ops.ell_pack(self._data, self._indices,
                                            self._indptr, rows, W)
                         if fits else False)
            _probed(sp, "ell", not fits, width=W)
        return self._ell if fits else None

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
        with _trace.span("dispatch.probe", format="bsr") as sp:
            st = None
            if ((settings.bsr_force or self.device.type == "cuda")
                    and settings.bsr_max_expand > 0
                    and self.dtype in (torch.float32, torch.bfloat16)
                    and self.has_canonical_format):
                from .ops import bsr as _bsr_ops

                st = _bsr_ops.build_structure(
                    self._data, self._indices, self._indptr,
                    self._get_row_ids(), self.shape,
                    settings.bsr_max_expand, probe=sp)
            self._bsr = st if st is not None else False
            _probed(sp, "bsr", st is None)
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
        with _trace.span("dispatch.probe", format="dia") as sp:
            dia = self._build_dia(sp)
            self._dia = dia if dia is not None else False
            _probed(sp, "dia", dia is None)
        return dia

    def _build_dia(self, sp):
        """``_get_dia``'s structure, or None; ``sp`` its probe's span."""
        rows, cols = self.shape
        nnz = self.nnz
        if (settings.dia_max_expand <= 0 or not nnz or not rows
                or not self.has_canonical_format):
            return None
        if self._dia_offsets is None:
            max_nd = int(min(settings.dia_max_diags,
                             settings.dia_max_expand * nnz / max(cols, 1)))
            offsets = (_dia_ops.csr_band_offsets(
                self._indices, self._get_row_ids(), max_nd, probe=sp)
                if max_nd >= 1 else None)
            self._dia_offsets = offsets if offsets is not None else False
        if self._dia_offsets is False:
            return None
        offsets = self._dia_offsets
        exact = _dia_ops.band_cover(offsets, self.shape, cols) == nnz
        if self.dtype in (torch.bfloat16, torch.float16):
            exact = True
        if exact:
            dia_data = _dia_ops.dia_from_csr(
                self._data, self._indices, self._get_row_ids(), offsets,
                cols)
            return (dia_data, offsets, None)
        dia_data, mask = _dia_ops.dia_from_csr(
            self._data, self._indices, self._get_row_ids(), offsets,
            cols, with_mask=True)
        return (dia_data, offsets, mask)

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

    def _get_sliced_ell(self):
        """Cached row-binned ELL pack (``ops/spmv.py::sliced_ell_pack``),
        or None for an empty matrix (reference ``csr.py:702-722``).
        Unlike flat ELL it has no padding budget: power-of-two row bins
        keep padding under 2x nnz whatever the skew.  ``dot`` does not
        take it (the JAX package reaches it through its autotuner); its
        SpMV is ``ops/spmv.py::sliced_ell_spmv`` (``_f32acc`` on
        compressed storage)."""
        if self._sliced_ell is not None:
            return self._sliced_ell if self._sliced_ell is not False else None
        rows = self.shape[0]
        if rows == 0 or self.nnz == 0 or rows > torch.iinfo(torch.int32).max:
            self._sliced_ell = False
            return None
        bins = _spmv_ops.sliced_ell_pack(self._data, self._indices,
                                         self._indptr, rows)
        self._sliced_ell = bins if bins is not None else False
        return bins

    # ---------------- matmul ----------------
    def _lowp(self, other_dtype: torch.dtype) -> bool:
        """The JAX package's widening rule (``csr.py:1349-1358``): bf16
        or f16 storage against an operand of another dtype whose result
        type is f32 keeps the compressed operand and takes the
        f32-accumulation paths, instead of casting the matrix up."""
        return (self.dtype in (torch.bfloat16, torch.float16)
                and other_dtype != self.dtype
                and torch.promote_types(self.dtype, other_dtype)
                == torch.float32)

    def dot(self, other, out=None):
        """``A @ other`` (reference ``csr.py:1321-1579``): SpGEMM for a
        sparse operand (``csr_array``, ``dia_array``, scipy), SpMV for
        x of shape (cols,) or (cols, 1), SpMM for X of shape (cols, k).
        numpy inputs and tensors on another device move to the matrix's
        device.

        Each SpMV and SpMM counts ``op.spmv``/``op.spmm``, records its
        host dispatch time in ``lat.spmv.<bucket>``/``lat.spmm.<bucket>``
        and, while tracing is on, a ``spmv``/``spmm`` span with its path,
        rows, nnz, bytes (``spmv_traffic_bytes``) and flops.

        With ``settings.resil`` on, the dispatch runs under the
        ``csr.dot`` site policy (JAX ``csr.py:1296-1318``): injectable,
        retried with deterministic backoff, K consecutive failures
        opening the site's breaker (a typed fast-fail while open).  Off,
        this is one flag read."""
        if settings.resil:
            def attempt():
                # The hook wraps the value, so an armed ``nonfinite``
                # fault can poison the product.
                return _rfaults.fault_point("csr.dot",
                                            self._dot_impl(other, out=out))

            return _rpolicy.run("csr.dot", attempt)
        return self._dot_impl(other, out=out)

    def _dot_impl(self, other, out=None):
        require_supported_dtype(self.dtype)
        if _is_scipy_sparse(other):
            other = csr_array(other, device=self.device)
        elif is_sparse_matrix(other) and not isinstance(other, csr_array):
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
        rows = self.shape[0]
        _obs_counters.handle("op.spmv").inc()
        lowp = self._lowp(x.dtype)
        if lowp:
            A, src = self, self
        else:
            A, x = cast_to_common_type(self, x)
            src = self if A is self else None
        with _trace.span("spmv") as sp:
            with _lat.timer("lat.spmv." + _lat.shape_bucket(rows)):
                y, path = self._routed(src, x, _engine_route_matvec,
                                       _autotune_route_matvec)
                if y is None:
                    y, path = self._spmv(A, src, x, lowp)
            if sp is not None:
                # Priced after the span's interval ends.  The engine's
                # plan is the CSR gather over padded operands: its
                # traffic is the CSR model's.
                sp.stop().set(path=path, rows=rows, nnz=self.nnz,
                              bytes=A.spmv_traffic_bytes(
                                  x, path="csr" if path == "engine"
                                  else path),
                              flops=2 * self.nnz)
        self.spmv_path = path
        if squeeze:
            y = y[:, None]
        return fill_out(y, out)

    @staticmethod
    def _routed(src, operand, engine_route, autotune_route):
        """``(y, path)`` of the engine rung, then the autotune rung
        (JAX ``csr.py:1361-1400``), or ``(None, None)`` when both
        decline (off, the default; a banded or block matrix; dtype
        promotion; a verdict miss)."""
        if src is None:
            return None, None
        y = engine_route(src, operand)
        if y is not None:
            return y, "engine"
        routed = autotune_route(src, operand)
        if routed is not None:
            return routed
        return None, None

    def _spmv(self, A, src, x, lowp: bool):
        """``(y, path)`` of ``A @ x`` in the JAX package's order (DIA →
        BSR → ELL → csr-rowids → csr).  Under ``lowp`` the band takes
        the plain shifted adds (products promoted to f32), BSR stands
        down, and ELL and csr-rowids take their f32-accumulation
        variants."""
        rows = self.shape[0]
        dia = src._get_dia() if src is not None else None
        bsr = (src._get_bsr()
               if src is not None and not lowp and dia is None else None)
        ell = (src._get_ell()
               if src is not None and dia is None and bsr is None else None)
        if dia is not None:
            packed = src._get_dia_pack() if not lowp else None
            if packed is not None:
                return _dia_kernel.dia_spmv(packed, x.contiguous()), \
                    "dia-kernel"
            return _dia_ops.dia_spmv_nopad(dia[0], dia[2], x, dia[1],
                                           self.shape), "dia-torch"
        if bsr is not None:
            return bsr.matvec(x), "bsr"
        if ell is not None and lowp:
            return _spmv_ops.ell_spmv_f32acc(ell[0], ell[1], ell[2],
                                             x), "ell-bf16"
        if ell is not None:
            return _spmv_ops.ell_spmv(ell[0], ell[1], ell[2], x), "ell"
        if src is not None and lowp:
            return _spmv_ops.csr_spmv_rowids_f32acc(
                A.data, A.indices, src._get_row_ids(), x,
                rows), "csr-rowids-bf16"
        if src is not None:
            return _spmv_ops.csr_spmv_rowids(
                A.data, A.indices, src._get_row_ids(), x, rows,
                lengths=src._get_row_lengths(),
                serial=src._serial_rows()), "csr-rowids"
        return _spmv_ops.csr_spmv(A.data, A.indices, A.indptr, x, rows,
                                  serial=self._serial_rows()), "csr"

    def _matmat(self, X: torch.Tensor) -> torch.Tensor:
        """SpMM ``A @ X`` for dense X (cols, k), in the SpMV branch's
        order DIA → BSR (k <= 512) → ELL → csr-rowids → csr; under the
        widening rule DIA's plain shifted adds, else
        ``"csr-rowids-bf16"``.  The label goes to ``spmm_path``."""
        from .ops.bsr import SPMM_MAX_K as _BSR_MAX_K

        if X.shape[0] != self.shape[1]:
            raise ValueError(f"dimension mismatch: {self.shape} @ "
                             f"{tuple(X.shape)}")
        rows = self.shape[0]
        _obs_counters.handle("op.spmm").inc()
        lowp = self._lowp(X.dtype)
        if lowp:
            A, src = self, self
        else:
            A, X = cast_to_common_type(self, X)
            src = self if A is self else None
        k = X.shape[1]
        with _lat.timer("lat.spmm." + _lat.shape_bucket(rows)), \
                _trace.span("spmm") as sp:
            Y, path = self._routed(src, X, _engine_route_matmat,
                                   _autotune_route_matmat)
            if Y is None:
                dia = src._get_dia() if src is not None else None
                bsr = (src._get_bsr()
                       if src is not None and not lowp and dia is None
                       and 0 < k <= _BSR_MAX_K else None)
                ell = (src._get_ell()
                       if src is not None and not lowp and dia is None
                       and bsr is None else None)
                if dia is not None:
                    # The cheap k gate first: no kernel pack for an X the
                    # kernel cannot take.
                    packed = (src._get_dia_pack()
                              if 0 < k <= _dia_kernel.SPMM_MAX_K
                              and not lowp else None)
                    if _dia_kernel.spmm_supported(packed, X):
                        Y = _dia_kernel.dia_spmm(packed, X.contiguous())
                        path = "dia-kernel"
                    else:
                        Y = _dia_ops.dia_spmm_masked(dia[0], dia[2], X,
                                                     dia[1], self.shape)
                        path = "dia-torch"
                elif bsr is not None:
                    Y = bsr.matmat(X)
                    path = "bsr"
                elif ell is not None:
                    Y = _spmv_ops.ell_spmm(ell[0], ell[1], ell[2], X)
                    path = "ell"
                elif src is not None and lowp:
                    Y = _spmv_ops.csr_spmm_rowids_f32acc(
                        A.data, A.indices, src._get_row_ids(), X, rows)
                    path = "csr-rowids-bf16"
                elif src is not None:
                    Y = _spmv_ops.csr_spmm_rowids(
                        A.data, A.indices, src._get_row_ids(), X, rows,
                        lengths=src._get_row_lengths(),
                        serial=src._serial_rows())
                    path = "csr-rowids"
                else:
                    Y = _spmv_ops.csr_spmm(A.data, A.indices, A.indptr, X,
                                           rows, serial=self._serial_rows())
                    path = "csr"
            if sp is not None:
                # Priced after the span's interval ends.
                sp.stop().set(path=path, rows=rows, k=int(k), nnz=self.nnz,
                              flops=2 * self.nnz * int(k),
                              bytes=A.spmv_traffic_bytes(
                                  X, path="csr" if path == "engine"
                                  else path))
        self.spmm_path = path
        return Y

    def _operand_bytes(self, x) -> Tuple[int, int]:
        """(bytes of ``x``, bytes of ``A @ x``) for ``spmv_traffic_bytes``."""
        out_bytes = self.shape[0] * torch.promote_types(self.dtype,
                                                        x.dtype).itemsize
        if x.dim() == 2:
            out_bytes *= int(x.shape[1])
        return x.numel() * x.element_size(), out_bytes

    def bsr_traffic_bytes(self, st, x) -> int:
        """Bytes one ``A @ x`` through the BSR kernels over the block
        list ``st`` (``ops/bsr.py::build_structure`` of this matrix)
        must move: the stored nonzeros, ``indptr``, the block list
        (``bcol``, ``bptr``), x and y.  ``spmv_traffic_bytes``'s
        ``"bsr"`` model, for a structure the matrix has not cached."""
        x_bytes, out_bytes = self._operand_bytes(x)
        return int(self.nnz * (self._data.element_size()
                               + self._indices.element_size())
                   + sum(t.numel() * t.element_size()
                         for t in (self._indptr, st.bcol, st.bptr))
                   + x_bytes + out_bytes)

    def spmv_traffic_bytes(self, x, path: Optional[str] = None) -> int:
        """Bytes one ``A @ x`` (or ``A @ X``) must move through the path
        ``path`` (a dispatch label; None: the path the built structure
        caches say the dispatch would take), each input read once and
        each output written once (reference ``csr.py:1582-1652``).  It
        reads the caches only, so call it after the product; without
        them it prices the CSR gather.

        The models follow the JAX package's, with two port-specific
        ones: ``"dia-kernel"`` reads the band and its int8 hole mask as
        ``"dia-torch"`` does, and ``"bsr"`` prices what the port's BSR
        kernels read, the stored nonzeros and the block list
        (``bcol``, ``bptr``), where the JAX package prices its
        densified blocks.  The ``-bf16`` variants stream what their
        families do, at the storage's itemsizes."""
        if path is not None and path.endswith("-bf16"):
            path = path[: -len("-bf16")]
        x_bytes, out_bytes = self._operand_bytes(x)
        val_b = self._data.element_size()
        idx_b = self._indices.element_size()
        dia = self._dia if self._dia is not False else None
        if path is not None and not path.startswith("dia"):
            dia = None
        if path == "bsr" and self._bsr not in (None, False):
            return self.bsr_traffic_bytes(self._bsr, x)
        if dia is not None:
            dia_data, _offsets, mask = dia
            mask_bytes = mask.numel() if mask is not None else 0
            return int(dia_data.numel() * dia_data.element_size()
                       + mask_bytes + x_bytes + out_bytes)
        if path == "sliced-ell" and self._sliced_ell not in (None, False):
            total = x_bytes + out_bytes
            for part in self._sliced_ell:
                total += sum(t.numel() * t.element_size() for t in part)
            return int(total)
        ell = self._ell if self._ell is not False else None
        if path is not None and path != "ell":
            ell = None
        if ell is not None:
            return int(sum(t.numel() * t.element_size() for t in ell)
                       + x_bytes + out_bytes)
        rid_bytes = (self._row_ids.numel() * self._row_ids.element_size()
                     if self._row_ids is not None else self.nnz * 4)
        return int(self.nnz * (val_b + idx_b) + rid_bytes + x_bytes
                   + out_bytes)

    def __rmatmul__(self, other):
        raise NotImplementedError("dense @ csr is not yet supported")

    def __str__(self) -> str:
        r, c, v = (to_numpy(t) for t in self._coo_parts())
        return "\n".join(f"  ({int(i)}, {int(j)})\t{x}"
                         for i, j, x in zip(r, c, v))

    def __repr__(self) -> str:
        return (f"<{self.shape[0]}x{self.shape[1]} sparse array of type "
                f"'{self.dtype}' with {self.nnz} stored elements in "
                f"Compressed Sparse Row format on {self.device}>")


class csr_matrix(csr_array):
    """scipy's ``csr_matrix`` flavour (reference ``csr.py:1961-2010``):
    ``*`` and ``**`` are the matrix product and power, and the legacy
    ``getrow``/``getcol``/``getH`` exist here only, as in scipy."""

    _is_spmatrix = True

    def __pow__(self, n):
        if not isinstance(n, (int, np.integer)) or n < 0:
            raise ValueError("matrix power requires a non-negative int")
        if self.shape[0] != self.shape[1]:
            raise TypeError("matrix is not square")
        from .gallery import identity

        result = csr_matrix(identity(self.shape[0], dtype=self.dtype,
                                     format="csr", device=self.device))
        base = self
        n = int(n)
        while n:
            if n & 1:
                result = csr_matrix(result.dot(base))
            n >>= 1
            if n:
                base = csr_matrix(base.dot(base))
        return result

    def getrow(self, i):
        return csr_matrix(self[int(i), :])

    def getcol(self, j):
        return csr_matrix(self[:, int(j)])

    def getH(self):
        return self.conj().transpose()

    def __mul__(self, other):
        if _is_scalar(other):
            return self._with_data(_scalar_op(self._data, other, torch.mul))
        return self.dot(other)

    def __rmul__(self, other):
        if _is_scalar(other):
            return self._with_data(_scalar_op(self._data, other, torch.mul))
        # scipy's spmatrix: x * A is x @ A (a row-vector product).
        other = as_tensor(other, self.device)
        AT = self.transpose()
        if other.dim() == 1:
            return to_numpy(AT @ other)
        return to_numpy(AT @ other.T).T


def _elementwise_intersect_multiply(a: csr_array, b: csr_array) -> csr_array:
    """Hadamard product of two canonical CSR matrices of one dtype
    (reference ``csr.py:2015-2043``): after one sort of the joined
    coordinates by (row, col), a coordinate in both is an adjacent pair,
    and the product of the pair's channel sums is its value."""
    rows, cols = a.shape
    ra, ca, va = a._coo_parts()
    rb, cb, vb = b._coo_parts()
    r = torch.cat([ra, rb])
    c = torch.cat([ca, cb])
    ch_a = torch.cat([va, torch.zeros_like(vb)])
    ch_b = torch.cat([torch.zeros_like(va), vb])
    key = r.to(torch.int64) * max(cols, 1) + c.to(torch.int64)
    order = torch.argsort(key, stable=True)
    key, r, c, ch_a, ch_b = (t[order] for t in (key, r, c, ch_a, ch_b))
    prod = (ch_a[:-1] + ch_a[1:]) * (ch_b[:-1] + ch_b[1:])
    out_rows, out_cols, out_vals = _convert.compact_mask(
        key[1:] == key[:-1], (r[:-1], c[:-1], prod))
    return csr_array._from_parts(
        out_vals, out_cols, _convert.indptr_from_row_ids(out_rows, rows),
        (rows, cols))


def spmv(A: csr_array, x, y):
    """Free-function SpMV: ``y <- A @ x``, ``y`` filled in place
    (reference ``csr.py:2045-2047``)."""
    return A.dot(x, out=y)


def spgemm_csr_csr_csr(A: csr_array, B: csr_array) -> csr_array:
    """C = A @ B for CSR operands of one dtype on one device (reference
    ``csr.py:2050-2136``); the route goes to ``A.spgemm_path``.

    When both operands are exact bands (DIA caches without a hole
    mask) and the product band is full and within the DIA budget, C is
    the Minkowski-sum band: the banded kernel for f32/bf16
    (``"dia-kernel"``), the kernel's plain version otherwise
    (``"dia-torch"``), then ``band_to_csr``, with C's DIA cache warm.
    Everything else runs expand-sort-compress (``"esc"``).  Counts
    ``op.spgemm``, times ``lat.spgemm.<bucket>`` and, while tracing is
    on, records a ``spgemm`` span (path, output nnz, bytes, flops)."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"dimension mismatch in spgemm: {A.shape} @ "
                         f"{B.shape}")
    m, k = A.shape
    n = B.shape[1]
    _obs_counters.handle("op.spgemm").inc()
    with _lat.timer("lat.spgemm." + _lat.shape_bucket(m)), \
            _trace.span("spgemm", m=m, k=k, n=n, nnz_a=A.nnz,
                        nnz_b=B.nnz) as sp:
        C = _spgemm(A, B, sp)
    return C


def _spgemm(A: csr_array, B: csr_array, sp) -> csr_array:
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
            if sp is not None:
                sp.set(path=path, nnz=nnz_c,
                       bytes=(dia_a[0].numel() + dia_b[0].numel()
                              + Cd.numel()) * Cd.element_size(),
                       flops=2 * len(dia_a[1]) * len(dia_b[1]) * n)
            return C
    data, indices, indptr, chunks = _spgemm_ops.spgemm_csr_csr_csr_impl(
        A.data, A.indices, A.indptr, B.data, B.indices, B.indptr, m, k, n)
    A.spgemm_path = "esc"
    C = csr_array._from_parts(data, indices, indptr, (m, n))
    if sp is not None:
        sp.set(path="esc", nnz=C.nnz, chunks=chunks,
               bytes=(A.nnz + B.nnz + C.nnz)
               * (C.data.element_size() + C.indices.element_size()))
    return C
