# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Gather-class SpMV in plain PyTorch.

Mirrors ``legate_sparse_tpu/ops/spmv.py``: ``csr_spmv`` (``:39``),
``csr_spmv_rowids`` (``:58``), ``ell_within_budget`` (``:545``),
``ell_pack`` (``:551``) and ``ell_spmv`` (``:161``).  The JAX package
leaves these to XLA; here they are ordinary tensor ops.  Padded and
masked slots contribute an exact 0 (a masked product, never ``0*x``),
so a non-finite x entry that no row stores never produces NaN.
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
