# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Format conversions (mirrors ``legate_sparse_tpu/ops/convert.py``):
indptr ↔ per-nonzero row ids, dense ↔ CSR and COO → CSR for the
constructors, the CSR transpose and diagonal extraction, mask
compaction and row selection (``compact_mask``, ``select_rows``), and
the segment reductions they, the facade's reductions and the SpGEMM
share, each of which gives the same result on every call on CUDA."""

from __future__ import annotations

import torch

from ..types import coord_dtype_for, nnz_dtype


def gather_index(idx: torch.Tensor) -> torch.Tensor:
    """``idx`` in a dtype torch can index with: compressed storage's
    int16 column indices (``csr_array.compress``) widen to int32, which
    a gather takes as it takes int64; int32 and int64 pass through
    without a copy."""
    return idx.to(torch.int32) if idx.dtype == torch.int16 else idx


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


def _lengths_to_ids(lengths: torch.Tensor, total: int) -> torch.Tensor:
    return torch.repeat_interleave(
        torch.arange(lengths.shape[0], dtype=torch.int64,
                     device=lengths.device), lengths, output_size=total)


def segment_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum of each run of ``lengths[s]`` consecutive values along dim 0
    (empty runs give 0).  ``torch.segment_reduce`` reduces each run on
    its own, so the result does not change from run to run on CUDA,
    unlike the atomic ``index_add_`` (which is kept for integers, whose
    sum does not depend on order); complex values are summed as (re,
    im), and bool values are OR-ed, as XLA's scatter-add does."""
    if vals.is_complex():
        out = torch.segment_reduce(torch.view_as_real(vals), "sum",
                                   lengths=lengths, axis=0)
        return torch.view_as_complex(out.contiguous())
    if vals.is_floating_point():
        return torch.segment_reduce(vals, "sum", lengths=lengths)
    seg = _lengths_to_ids(lengths, vals.shape[0])
    out = torch.zeros((lengths.shape[0],) + tuple(vals.shape[1:]),
                      dtype=torch.int64 if vals.dtype == torch.bool
                      else vals.dtype, device=vals.device)
    out.index_add_(0, seg, vals.to(out.dtype))
    return out != 0 if vals.dtype == torch.bool else out


def segment_extreme(vals: torch.Tensor, lengths: torch.Tensor,
                    op: str) -> torch.Tensor:
    """Max (``op="max"``) or min of each run of ``lengths[s]``
    consecutive values; an empty run gives -inf/+inf (integers: the
    type's min/max).  NaN propagates, as in XLA's max and min."""
    if vals.is_floating_point():
        return torch.segment_reduce(vals, op, lengths=lengths)
    info = torch.iinfo(vals.dtype)
    init = info.min if op == "max" else info.max
    out = torch.full((lengths.shape[0],), init, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce(0, _lengths_to_ids(lengths, vals.shape[0]),
                              vals, "amax" if op == "max" else "amin")


def compact_mask(mask: torch.Tensor, arrays) -> tuple:
    """The elements of each array where ``mask`` is True, in order
    (``:158``).  One host sync: the count of True elements, which
    ``torch.nonzero`` takes where the JAX package takes
    ``int(mask.sum())``."""
    idx = torch.nonzero(mask).reshape(-1)
    return tuple(a[idx] for a in arrays)


def select_rows(data, indices, indptr, rows_idx, nnz_out: int):
    """(data, indices, indptr) of the rows ``rows_idx`` (any order,
    repeats allowed) of a CSR matrix (``:170``); ``nnz_out`` is their
    total count of entries, summed on the host by the caller."""
    starts = indptr[rows_idx]
    counts = indptr[rows_idx + 1] - starts
    new_indptr = indptr_from_counts(counts)
    out_row = _lengths_to_ids(counts, nnz_out)
    src = (starts[out_row]
           + torch.arange(nnz_out, dtype=torch.int64, device=data.device)
           - new_indptr[out_row])
    return data[src], indices[src], new_indptr


def coo_to_csr(rows_idx, cols_idx, values, rows: int):
    """Stable sort of COO entries by row, then indptr (``:110``):
    the order within a row is the input order, duplicates are kept."""
    order = torch.argsort(rows_idx, stable=True)
    return (values[order], cols_idx[order],
            indptr_from_row_ids(rows_idx[order], rows))


def csr_transpose(data, indices, indptr, rows: int, cols: int):
    """CSR of the transpose (``:126``): expand the row ids, sort stably
    by column, rebuild indptr.  The new indices take the old ones'
    dtype, but at least int32 (int16 column indices say nothing of the
    row count)."""
    row_ids = row_ids_from_indptr(indptr, data.shape[0])
    order = torch.argsort(indices, stable=True)
    return (data[order],
            row_ids[order].to(torch.promote_types(indices.dtype,
                                                  torch.int32)),
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
