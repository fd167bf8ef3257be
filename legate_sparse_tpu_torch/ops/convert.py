# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Format conversions (mirrors ``legate_sparse_tpu/ops/convert.py``):
indptr → per-nonzero row ids, and dense ↔ CSR for the constructors."""

from __future__ import annotations

import torch

from ..types import coord_dtype_for, nnz_dtype


def row_ids_from_indptr(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Per-nonzero row ids of a CSR indptr (same dtype as ``indptr``)."""
    rows = indptr.shape[0] - 1
    if nnz == 0:
        return torch.zeros((0,), dtype=indptr.dtype, device=indptr.device)
    counts = indptr[1:] - indptr[:-1]
    return torch.repeat_interleave(
        torch.arange(rows, dtype=indptr.dtype, device=indptr.device),
        counts, output_size=nnz,
    )


def indptr_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """indptr (rows+1,) from per-row counts."""
    out = torch.zeros((counts.shape[0] + 1,), dtype=nnz_dtype(),
                      device=counts.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


def dense_to_csr(dense: torch.Tensor):
    """(data, indices, indptr) of a 2-D dense tensor, row-major order
    (the order of ``jnp.nonzero`` in the JAX package)."""
    rows, cols = dense.shape
    ridx, cidx = torch.nonzero(dense, as_tuple=True)
    data = dense[ridx, cidx]
    counts = torch.bincount(ridx, minlength=rows)
    return (data, cidx.to(coord_dtype_for(max(rows, cols))),
            indptr_from_counts(counts))


def csr_to_dense(data, indices, indptr, shape) -> torch.Tensor:
    """Scatter CSR entries into a dense tensor (duplicates accumulate)."""
    rows, cols = shape
    row_ids = row_ids_from_indptr(indptr, data.shape[0])
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    out.index_put_((row_ids, indices.to(torch.int64)), data,
                   accumulate=True)
    return out
