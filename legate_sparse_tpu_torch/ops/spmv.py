# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Gather-class SpMV and SpMM in plain PyTorch.

Mirrors ``legate_sparse_tpu/ops/spmv.py``: ``csr_spmv`` (``:39``),
``csr_spmv_rowids`` (``:58``), ``ell_within_budget`` (``:545``),
``ell_pack`` (``:551``), ``ell_spmv`` (``:161``), ``ell_spmm``
(``:515``), ``csr_spmm_rowids`` (``:589``) and ``csr_spmm``
(``:599``).  The JAX package leaves these to XLA; here they are
ordinary tensor ops.  Padded and masked slots contribute an exact 0 (a
masked product, never ``0*x``), so a non-finite x entry that no row
stores never produces NaN.
"""

from __future__ import annotations

import torch

from .convert import row_ids_from_indptr


def csr_spmv_rowids(data, indices, row_ids, x, rows: int) -> torch.Tensor:
    """y[i] = Σ data[j]·x[indices[j]] over the nonzeros j of row i, with
    per-nonzero row ids precomputed."""
    prod = data * x[indices]
    y = torch.zeros((rows,), dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, row_ids, prod)


def csr_spmv(data, indices, indptr, x, rows: int) -> torch.Tensor:
    """CSR SpMV that expands the row ids on every call."""
    return csr_spmv_rowids(data, indices,
                           row_ids_from_indptr(indptr, data.shape[0]),
                           x, rows)


def ell_within_budget(rows: int, W: int, nnz: int,
                      max_expand: float) -> bool:
    """ELL padding budget: ``rows * W <= max_expand * nnz``."""
    return max_expand > 0 and rows * W <= max_expand * max(nnz, 1)


def ell_pack(data, indices, indptr, rows: int, W: int):
    """CSR → ELL: ``(ell_data, ell_cols, ell_counts)``, (rows, W) value
    and column blocks plus the (rows,) per-row counts.  Padded slots
    repeat the row's last column with value 0; ``ell_spmv`` masks
    their products."""
    nnz = indices.shape[0]
    counts = (indptr[1:] - indptr[:-1]).to(torch.int32)
    if nnz == 0:
        return (torch.zeros((rows, W), dtype=data.dtype, device=data.device),
                torch.zeros((rows, W), dtype=indices.dtype,
                            device=data.device),
                counts)
    slot = torch.arange(W, dtype=indptr.dtype, device=indptr.device)
    row_start = indptr[:-1, None]
    row_last = torch.clamp(indptr[1:, None] - 1, 0, nnz - 1)
    src = torch.minimum(row_start + slot[None, :], row_last)
    valid = slot[None, :] < counts[:, None]
    ell_cols = indices[src]
    ell_data = torch.where(valid, data[src], torch.zeros((), dtype=data.dtype,
                                                         device=data.device))
    return ell_data, ell_cols, counts


def ell_spmv(ell_data, ell_cols, ell_counts, x) -> torch.Tensor:
    """SpMV over an ELL pack: one 2-D gather and a masked row sum."""
    W = ell_data.shape[1]
    slot = torch.arange(W, dtype=ell_counts.dtype, device=ell_counts.device)
    valid = slot[None, :] < ell_counts[:, None]
    prod = ell_data * x[ell_cols]
    prod = torch.where(valid, prod, torch.zeros((), dtype=prod.dtype,
                                                device=prod.device))
    return prod.sum(dim=1)


# Above this many intermediate elements (rows * W * k) ``ell_spmm``
# accumulates one ELL slot at a time instead of materialising the whole
# (rows, W, k) product (the JAX package's cap, ``spmv.py:510``).
_ELL_SPMM_MATERIALIZE_CAP = 1 << 27


def ell_spmm(ell_data, ell_cols, ell_counts, X) -> torch.Tensor:
    """Y = A @ X (X dense, (cols, k)) over an ELL pack, padded slots'
    products masked to an exact 0."""
    rows, W = ell_data.shape
    k = X.shape[1]
    slot = torch.arange(W, dtype=ell_counts.dtype, device=ell_counts.device)
    valid = slot[None, :] < ell_counts[:, None]
    zero = torch.zeros((), dtype=ell_data.dtype, device=ell_data.device)
    if rows * W * k <= _ELL_SPMM_MATERIALIZE_CAP:
        prod = ell_data[:, :, None] * X[ell_cols.to(torch.int64), :]
        return torch.where(valid[:, :, None], prod, zero).sum(dim=1)
    Y = torch.zeros((rows, k), dtype=ell_data.dtype, device=X.device)
    for w in range(W):
        prod = ell_data[:, w, None] * X[ell_cols[:, w].to(torch.int64), :]
        Y = Y + torch.where(valid[:, w, None], prod, zero)
    return Y


def csr_spmm_rowids(data, indices, row_ids, X, rows: int) -> torch.Tensor:
    """Y = A @ X with per-nonzero row ids precomputed: gather the rows
    of X, scale, add per row."""
    prod = data[:, None] * X[indices.to(torch.int64), :]
    Y = torch.zeros((rows, X.shape[1]), dtype=prod.dtype, device=prod.device)
    return Y.index_add_(0, row_ids, prod)


def csr_spmm(data, indices, indptr, X, rows: int) -> torch.Tensor:
    """CSR SpMM that expands the row ids on every call."""
    return csr_spmm_rowids(data, indices,
                           row_ids_from_indptr(indptr, data.shape[0]),
                           X, rows)
