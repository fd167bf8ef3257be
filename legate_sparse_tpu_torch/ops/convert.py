# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Format conversions (mirrors ``legate_sparse_tpu/ops/convert.py``):
indptr ↔ per-nonzero row ids, dense ↔ CSR and COO → CSR for the
constructors, the CSR transpose and diagonal extraction, and the
deterministic segment sum they and the SpGEMM share."""

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


def indptr_from_row_ids(row_ids: torch.Tensor, rows: int) -> torch.Tensor:
    """indptr (rows+1,) of sorted per-nonzero row ids (``:61``)."""
    return indptr_from_counts(torch.bincount(row_ids.to(torch.int64),
                                             minlength=rows))


def segment_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum of each run of ``lengths[s]`` consecutive values (empty runs
    give 0).  ``torch.segment_reduce`` reduces each run on its own, so
    the result does not change from run to run on CUDA, unlike the
    atomic ``index_add_``; complex values are summed as (re, im)."""
    if vals.is_complex():
        out = torch.segment_reduce(torch.view_as_real(vals), "sum",
                                   lengths=lengths, axis=0)
        return torch.view_as_complex(out.contiguous())
    return torch.segment_reduce(vals, "sum", lengths=lengths)


def coo_to_csr(rows_idx, cols_idx, values, rows: int):
    """Stable sort of COO entries by row, then indptr (``:110``):
    the order within a row is the input order, duplicates are kept."""
    order = torch.argsort(rows_idx, stable=True)
    return (values[order], cols_idx[order],
            indptr_from_row_ids(rows_idx[order], rows))


def csr_transpose(data, indices, indptr, rows: int, cols: int):
    """CSR of the transpose (``:126``): expand the row ids, sort stably
    by column, rebuild indptr."""
    row_ids = row_ids_from_indptr(indptr, data.shape[0])
    order = torch.argsort(indices, stable=True)
    return (data[order], row_ids[order].to(indices.dtype),
            indptr_from_row_ids(indices[order], cols))


def csr_diagonal(data, indices, indptr, rows: int, k: int = 0):
    """Entries at column ``i + k`` summed per row i, (rows,) (``:143``):
    absent entries are 0, duplicates add up."""
    row_ids = row_ids_from_indptr(indptr, data.shape[0])
    on_diag = indices.to(torch.int64) == row_ids.to(torch.int64) + k
    contrib = torch.where(on_diag, data,
                          torch.zeros((), dtype=data.dtype,
                                      device=data.device))
    return segment_sum(contrib, indptr[1:] - indptr[:-1])


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
