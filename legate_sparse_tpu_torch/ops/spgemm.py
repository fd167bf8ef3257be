# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""SpGEMM: C = A @ B for CSR operands by expand-sort-compress (ESC).

Mirrors ``legate_sparse_tpu/ops/spgemm.py:43-280`` in plain PyTorch:

1. **Expand**: every nonzero A[i, t] times row t of B gives T = Σ over
   A's nonzeros of nnz(B row t) triplets (i, j, a·b), in A-nonzero
   order.
2. **Sort** the triplets by (i, j).  PyTorch has no multi-key sort, so
   the key is one int64 ``i * n + j`` (exact for any extent up to
   2^31), sorted stably.
3. **Compress**: sum each run of equal keys (``convert.segment_sum``, a
   reduction per run whose result does not change from run to run on
   CUDA, unlike the atomic ``index_add_``) and compact to nnz(C).

Two host syncs bracket the phases, as in the JAX package: the product
count T (``spgemm_num_products``) and nnz(C) (``coalesce_coo``).  When
T exceeds ``chunk_products`` (by default
``settings.spgemm_chunk_products``), the expansion runs
in chunks along A's nonzeros (``_chunk_bounds``/``_expand_range``),
each chunk is coalesced, and the accumulated triplets are folded
whenever they outgrow the chunk budget: peak memory O(chunk + nnz(C)).
The JAX package pads every chunk to one capacity so that one compiled
program serves them all; eager PyTorch needs no padding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..types import coord_dtype_for, nnz_dtype
from .convert import indptr_from_row_ids, row_ids_from_indptr, segment_sum


def spgemm_num_products(a_indices, b_indptr) -> int:
    """T, the number of expanded products (a host sync)."""
    counts = (b_indptr[1:] - b_indptr[:-1])[a_indices.to(torch.int64)]
    return int(counts.sum())


def _expand_range(a_data, a_indices, a_rows, b_data, b_indices, b_indptr,
                  e_lo: int, e_hi: int, num_products: int):
    """(rows, cols, vals) of the products of A's nonzeros [e_lo, e_hi),
    in A-nonzero order; ``num_products`` is their count."""
    dev = a_data.device
    a_idx = a_indices[e_lo:e_hi].to(torch.int64)
    cnt = (b_indptr[1:] - b_indptr[:-1])[a_idx]
    e = torch.repeat_interleave(
        torch.arange(e_lo, e_hi, dtype=torch.int64, device=dev), cnt,
        output_size=num_products)
    # Offset of each product within its B row.
    starts = torch.cumsum(cnt, 0) - cnt
    within = (torch.arange(num_products, dtype=torch.int64, device=dev)
              - torch.repeat_interleave(starts, cnt,
                                        output_size=num_products))
    b_pos = b_indptr[a_indices[e].to(torch.int64)] + within
    rows = a_rows[e].to(torch.int64)
    cols = b_indices[b_pos].to(torch.int64)
    vals = a_data[e] * b_data[b_pos]
    return rows, cols, vals


def _sort_compress(rows, cols, vals, n: int):
    """Sort triplets by (row, col) and sum duplicate runs: (rows, cols,
    vals) of the distinct coordinates, row-major.  One host sync."""
    key = rows * max(n, 1) + cols
    key, order = torch.sort(key, stable=True)
    vals = vals[order]
    heads = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    heads[1:] = key[1:] != key[:-1]
    head_idx = torch.nonzero(heads).reshape(-1)
    ends = torch.cat([head_idx[1:],
                      torch.tensor([key.shape[0]], dtype=torch.int64,
                                   device=key.device)])
    out_vals = segment_sum(vals, ends - head_idx)
    out_key = key[head_idx]
    out_rows = torch.div(out_key, max(n, 1), rounding_mode="floor")
    return out_rows, out_key - out_rows * max(n, 1), out_vals


def coalesce_coo(rows, cols, vals, m: int, n: int):
    """Sort and merge duplicate coordinates: the CSR triple
    ``(data, indices, indptr)`` of an (m, n) matrix."""
    if rows.shape[0] == 0:
        return _empty(vals.dtype, m, n, vals.device)
    r, c, v = _sort_compress(rows, cols, vals, n)
    return v, c.to(coord_dtype_for(max(m, n))), indptr_from_row_ids(r, m)


def _empty(dtype, m: int, n: int, device):
    return (torch.zeros((0,), dtype=dtype, device=device),
            torch.zeros((0,), dtype=coord_dtype_for(max(m, n)),
                        device=device),
            torch.zeros((m + 1,), dtype=nnz_dtype(), device=device))


def _chunk_bounds(a_indices, b_indptr, num_products: int,
                  chunk_products: int):
    """Split A's nonzeros so that each chunk emits at most
    ``chunk_products`` products (a single nonzero that emits more gets
    a chunk of its own).  Returns ``(bounds, starts)`` on the host."""
    counts = (b_indptr[1:] - b_indptr[:-1])[a_indices.to(torch.int64)]
    counts = counts.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    bounds = [0]
    while starts[bounds[-1]] < num_products:
        nxt = int(np.searchsorted(starts, starts[bounds[-1]] + chunk_products,
                                  side="right") - 1)
        nxt = max(nxt, bounds[-1] + 1)            # always make progress
        bounds.append(min(nxt, len(starts) - 1))
    return bounds, starts


def spgemm_csr_csr_csr_impl(a_data, a_indices, a_indptr, b_data, b_indices,
                            b_indptr, m: int, k: int, n: int,
                            chunk_products=None) -> Tuple:
    """ESC SpGEMM of two CSR operands of one dtype: ``(data, indices,
    indptr, num_chunks)``, the CSR triple of the (m, n) product (rows
    canonical, every structural entry kept) and the number of expansion
    chunks it took (1: one pass)."""
    from ..settings import settings

    if chunk_products is None:
        chunk_products = settings.spgemm_chunk_products
    dtype = torch.promote_types(a_data.dtype, b_data.dtype)
    dev = a_data.device
    num_products = spgemm_num_products(a_indices, b_indptr)
    if num_products == 0:
        return (*_empty(dtype, m, n, dev), 1)
    a_rows = row_ids_from_indptr(a_indptr, a_data.shape[0])
    if num_products <= chunk_products:
        r, c, v = _expand_range(a_data, a_indices, a_rows, b_data,
                                b_indices, b_indptr, 0, a_data.shape[0],
                                num_products)
        return (*coalesce_coo(r, c, v, m, n), 1)

    bounds, starts = _chunk_bounds(a_indices, b_indptr, num_products,
                                   chunk_products)
    cap = int(max(starts[b1] - starts[b0]
                  for b0, b1 in zip(bounds[:-1], bounds[1:])))
    acc = None
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        t = int(starts[b1] - starts[b0])
        if t == 0:
            continue
        part = _sort_compress(*_expand_range(
            a_data, a_indices, a_rows, b_data, b_indices, b_indptr, b0, b1,
            t), n)
        acc = part if acc is None else tuple(
            torch.cat([x, y]) for x, y in zip(acc, part))
        del part
        # Fold whenever the accumulated triplets outgrow the chunk
        # budget, so peak memory stays O(chunk + nnz(C)).
        if acc[0].shape[0] > max(chunk_products, cap):
            acc = _sort_compress(*acc, n)
    num_chunks = len(bounds) - 1
    if acc is None:
        return (*_empty(dtype, m, n, dev), num_chunks)
    return (*coalesce_coo(*acc, m, n), num_chunks)
