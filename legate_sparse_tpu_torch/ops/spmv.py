# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Gather-class SpMV and SpMM in plain PyTorch.

Mirrors ``legate_sparse_tpu/ops/spmv.py``: ``csr_spmv`` (``:39``),
``csr_spmv_rowids`` (``:58``; on the card, with ``csr_spmm_rowids``
and ``csr_multi_spmv_rowids_masked``, the CUDA kernel of
``ops/csr_kernel.py``), the masked padded-suffix products
``csr_spmv_rowids_masked`` (``:68``) and ``csr_spmm_rowids_masked``
(``:85``) of the distributed blocks, ``ell_within_budget`` (``:545``),
``ell_pack`` (``:551``), ``ell_spmv`` (``:161``; on the card the CUDA
kernel of ``ops/ell_kernel.py``), ``ell_spmm``
(``:515``), ``csr_spmm_rowids`` (``:589``), ``csr_spmm``
(``:599``), the row-binned ELL ``sliced_ell_pack`` (``:180``) and
``sliced_ell_spmv`` (``:230``), the f32-accumulation variants of
compressed storage ``csr_spmv_rowids_f32acc`` (``:270``),
``csr_spmv_rowids_masked_f32acc`` (``:283``),
``csr_spmm_rowids_f32acc`` (``:305``), ``ell_spmv_f32acc`` (``:318``)
and ``sliced_ell_spmv_f32acc`` (``:335``), and the semiring products
``csgraph`` relaxes with:
``semiring_identity`` (``:381``), ``_semiring_product`` (``:398``),
``csr_semiring_spmv_rowids_masked`` (``:412``),
``csr_semiring_spmm_rowids_masked`` (``:431``), ``ell_semiring_spmv``
(``:450``), ``ell_semiring_spmm`` (``:465``) and
``sliced_ell_semiring_spmv`` (``:484``) that the graph layer computes
over, and the delta layer's ``coo_spmv_segment`` (``:137``).  The JAX
package leaves these to XLA; here they are ordinary tensor ops.  Padded and
masked slots of the plus-times products contribute an exact 0 (a
masked product, never ``0*x``), so a non-finite x entry that no row
stores never produces NaN.  Column indices may be compressed storage's
int16; every gather widens them (``convert.gather_index``).
"""

from __future__ import annotations

import math

import torch

import numpy as np

from ..obs import trace as _trace
from .convert import gather_index, row_ids_from_indptr, segment_sum
from . import csr_kernel as _csr_kernel
from . import ell_kernel as _ell_kernel


def csr_kernel_takes(data, indices, x) -> bool:
    """Whether the csr-rowids products take the CUDA kernel
    (``csr_kernel.csr_spmv``) for these operands: CUDA f32 or f64 values
    with x of their type and int32 or int64 columns."""
    return x.device.type == "cuda" and _csr_kernel.supported(data, indices, x)


def _kernel_offsets(row_ids, rows: int, lengths, offsets):
    """The rows' offsets the kernel reads: ``offsets`` as given, else
    one ``cumsum`` of ``lengths`` (counted from ``row_ids`` when
    absent)."""
    if offsets is not None:
        return offsets
    if lengths is None:
        lengths = _row_lengths(row_ids, rows)[:rows]
    return _csr_kernel.offsets_from_lengths(lengths)


def csr_spmv_rowids(data, indices, row_ids, x, rows: int, lengths=None,
                    serial=None, offsets=None,
                    schedule=None) -> torch.Tensor:
    """y[i] = Σ data[j]·x[indices[j]] over the nonzeros j of row i.  On
    the card, f32 or f64 values with x of the same type and int32 or
    int64 columns take the CUDA kernel (``csr_kernel.csr_spmv``: one pass
    over the values and columns, each row summed in an order that
    depends only on its own slots, slot order for rows of at most
    ``csr_kernel.CHUNK`` entries); it reads ``offsets`` (the ``rows + 1``
    row pointers, int32 or int64; one ``cumsum`` of ``lengths`` when
    absent) and ``schedule`` (``csr_kernel.build_schedule``'s; built on
    each call when absent).  Every other operand (complex, integer,
    low-precision, int16 columns, mixed types) and every CPU operand
    takes ``csr_spmv_rowids_plain``.  While tracing is on, each call is
    a ``kernel.csr_rowids`` span with its ``rows``, ``entries`` and
    ``serial`` (None where ``row_sums`` chose); the kernel's own
    ``kernel.csr_spmv`` span nests in it."""
    with _trace.span("kernel.csr_rowids") as sp:
        if sp is not None:
            sp.set(rows=rows, entries=int(data.shape[0]), serial=serial)
        if csr_kernel_takes(data, indices, x):
            return _csr_kernel.csr_spmv(
                data, indices, _kernel_offsets(row_ids, rows, lengths,
                                               offsets),
                x.contiguous(), schedule)
        return csr_spmv_rowids_plain(data, indices, row_ids, x, rows,
                                     lengths, serial)


def csr_spmv_rowids_plain(data, indices, row_ids, x, rows: int,
                          lengths=None, serial=None) -> torch.Tensor:
    """``csr_spmv_rowids`` in plain PyTorch, with per-nonzero row ids
    precomputed.  Float rows sum through ``row_sums``, the same bits on
    every call on the card (an atomic ``index_add_`` sums in no fixed
    order); integers, whose sum does not depend on order, keep
    ``index_add_``.  ``lengths`` are the rows' lengths
    (``csr_array._get_row_lengths``: counted from ``row_ids`` when
    absent) and ``serial`` the summation order
    (``csr_array._serial_rows``: taken from the longest row, one host
    sync, when absent)."""
    prod = data * x[gather_index(indices)]
    if not (prod.is_floating_point() or prod.is_complex()):
        y = torch.zeros((rows,), dtype=prod.dtype, device=prod.device)
        return y.index_add_(0, row_ids, prod)
    if lengths is None:
        lengths = _row_lengths(row_ids, rows)[:rows]
    return row_sums(prod, lengths, serial)


def csr_spmv_rowids_masked(data, indices, row_ids, valid_nnz, x,
                           rows: int) -> torch.Tensor:
    """SpMV over a zero-padded nonzero suffix (a distributed padded-CSR
    block): slots at or past ``valid_nnz`` contribute an exact 0 (the
    product is masked, not multiplied by 0); ``row_ids`` sorted, summed
    per row in slot order.  A padded slot may carry the out-of-range id
    ``rows``, whose sum is dropped, as the JAX package's
    ``segment_sum`` drops it."""
    slot = torch.arange(data.shape[0], device=data.device)
    prod = data * x[gather_index(indices)]
    prod = torch.where(slot < valid_nnz, prod,
                       torch.zeros((), dtype=prod.dtype, device=prod.device))
    return segment_sum(prod, _row_lengths(row_ids, rows))[:rows]


def csr_spmm_rowids_masked(data, indices, row_ids, valid_nnz, X,
                           rows: int) -> torch.Tensor:
    """``csr_spmv_rowids_masked`` for a dense (cols, k) X."""
    slot = torch.arange(data.shape[0], device=data.device)
    prod = data[:, None] * X[gather_index(indices), :]
    prod = torch.where((slot < valid_nnz)[:, None], prod,
                       torch.zeros((), dtype=prod.dtype, device=prod.device))
    return segment_sum(prod, _row_lengths(row_ids, rows))[:rows]


def csr_multi_spmv_rowids_masked(data, indices, row_ids, valid_nnz, X,
                                 rows: int, b: int, lengths=None,
                                 serial=None, kernel=None) -> torch.Tensor:
    """``b`` independent masked SpMVs in one stacked dispatch (the
    gateway's cross-tenant batch): row ``i`` of the (b, nnz) operands
    is matrix ``i``'s padded pack, ``X[i]`` its own x.  Each matrix's
    segments are offset by ``i * (rows + 1)``: the ``+ 1`` keeps its
    padding row id ``rows`` inside its own dropped segment instead of
    aliasing matrix ``i + 1``'s row 0.  One gather, one ``where`` and
    one segmented sum (``row_sums`` in the packs' one ``serial``
    order); per matrix the products and the order of each row's sum are
    those of the single product, so packing requests is invisible to
    each of them.  A slot with ``valid_nnz == 0`` (batch padding)
    contributes only exact zeros.  ``lengths`` is (b, s) with s >
    ``rows`` (an engine pack's: its rows, then its padding segments),
    or, counted from ``row_ids`` when absent, (b, rows + 1).

    On the card, f32/f64 values with X of their type and int32 or int64
    columns take ``csr_kernel.csr_spmv`` matrix by matrix: each masked
    slot's value 0 and its column the zero entry appended to ``X[i]``,
    so a masked slot's product is an exact +0.0 as above, and each row
    sums as the kernel sums it in the single product, since its order
    depends only on its own slots.  ``kernel`` holds the first
    matrices' segment offsets and schedules (an engine pack's, built
    once with it); the matrices past it are batch padding, whose rows
    read +0.0 with no launch.  Absent, each matrix's are built on the
    call from ``lengths``."""
    nnz = data.shape[1]
    slot = torch.arange(nnz, device=data.device)
    live = slot[None, :] < valid_nnz[:, None]
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if lengths is None:
        lengths = torch.stack([_row_lengths(row_ids[i], rows)
                               for i in range(b)])
    if X.shape[1] and csr_kernel_takes(data[0], indices[0], X[0]):
        cols = X.shape[1]
        if kernel is None:
            kernel = []
            for i in range(b):
                offsets = _csr_kernel.offsets_from_lengths(lengths[i])
                kernel.append((offsets,
                               _csr_kernel.build_schedule(offsets, nnz)))
        Xe = torch.nn.functional.pad(X, (0, 1))
        vals = torch.where(live, data, zero)
        idx = torch.where(live, indices,
                          torch.full((), cols, dtype=indices.dtype,
                                     device=data.device))
        ys = [_csr_kernel.csr_spmv(vals[i], idx[i], offsets, Xe[i],
                                   schedule)[:rows]
              for i, (offsets, schedule) in enumerate(kernel)]
        ys += [X.new_zeros((rows,))] * (b - len(ys))
        return torch.stack(ys)
    gathered = torch.gather(X, 1, gather_index(indices))
    prod = torch.where(live, data * gathered, zero)
    out = row_sums(prod.reshape(-1), lengths.reshape(-1), serial)
    return out.reshape(b, lengths.shape[1])[:, :rows]


def reads_row_ids(data, x) -> bool:
    """Whether a csr-rowids product of ``data`` and ``x`` given its rows'
    lengths reads per-entry row ids: an integer product alone
    (``index_add_``); a float or complex one sums by the lengths (and,
    on the card, reads the row offsets)."""
    out = torch.promote_types(data.dtype, x.dtype)
    return not (out.is_floating_point or out.is_complex)


def _plain_row_ids(data, indptr, x):
    """Row ids for the plain csr-rowids products where they read them
    (``reads_row_ids``), else None."""
    if not reads_row_ids(data, x):
        return None
    return row_ids_from_indptr(indptr, data.shape[0])


def csr_spmv(data, indices, indptr, x, rows: int,
             serial=None) -> torch.Tensor:
    """CSR SpMV that expands the row ids on every call that needs
    them."""
    return csr_spmv_rowids(data, indices,
                           _plain_row_ids(data, indptr, x),
                           x, rows, lengths=indptr[1:] - indptr[:-1],
                           serial=serial, offsets=indptr)


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


# The JAX package's name for its device-side pack; every pack here is
# built on the matrix's device.
ell_pack_device = ell_pack


def ell_spmv(ell_data, ell_cols, ell_counts, x) -> torch.Tensor:
    """SpMV over an ELL pack.  On the card, f32 or f64 values with x of
    the same type, int32 or int64 columns and 1 to
    ``ell_kernel.MAX_TILE_W`` slots a row take the CUDA kernel
    (``ell_kernel.ell_spmv``: one pass over each row's slots, the
    products added in slot order); every other dtype there (complex,
    low-precision, integer, mixed), a wider pack, and every CPU operand
    take ``ell_spmv_plain``."""
    if x.device.type == "cuda" and _ell_kernel.supported(
            ell_data, ell_cols, ell_counts, x):
        return _ell_kernel.ell_spmv(ell_data, ell_cols, ell_counts,
                                    x.contiguous())
    return ell_spmv_plain(ell_data, ell_cols, ell_counts, x)


def ell_spmv_plain(ell_data, ell_cols, ell_counts, x) -> torch.Tensor:
    """SpMV over an ELL pack in plain PyTorch: one 2-D gather and a
    masked row sum."""
    W = ell_data.shape[1]
    slot = torch.arange(W, dtype=ell_counts.dtype, device=ell_counts.device)
    valid = slot[None, :] < ell_counts[:, None]
    prod = ell_data * x[gather_index(ell_cols)]
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


def csr_spmm_rowids(data, indices, row_ids, X, rows: int, lengths=None,
                    serial=None, offsets=None,
                    schedule=None) -> torch.Tensor:
    """Y = A @ X with per-nonzero row ids precomputed: gather the rows
    of X, scale, sum per row.  Floats sum each column as
    ``csr_spmv_rowids`` sums its one (``row_sums``), so column j is bit
    for bit the SpMV of ``X[:, j]``; integers keep ``index_add_``.  The
    gather runs on X's transpose, one contiguous row a column: on CUDA
    a gather of X's short rows is several times slower.  Where
    ``csr_spmv_rowids`` takes the CUDA kernel, each column is one
    kernel product of that column (``offsets`` and ``schedule`` as
    there, the schedule built once a call when absent)."""
    Xt = X.T.contiguous()
    if X.shape[1] and csr_kernel_takes(data, indices, Xt[0]):
        offsets = _kernel_offsets(row_ids, rows, lengths, offsets)
        if schedule is None:
            schedule = _csr_kernel.build_schedule(offsets, data.shape[0])
        return torch.stack([_csr_kernel.csr_spmv(data, indices, offsets,
                                                 Xt[j], schedule)
                            for j in range(X.shape[1])], dim=1)
    prod = (data * Xt.index_select(1, gather_index(indices))).T
    if not (prod.is_floating_point() or prod.is_complex()):
        Y = torch.zeros((rows, X.shape[1]), dtype=prod.dtype,
                        device=prod.device)
        return Y.index_add_(0, row_ids, prod)
    if lengths is None:
        lengths = _row_lengths(row_ids, rows)[:rows]
    return row_sums(prod, lengths, serial)


def csr_spmm(data, indices, indptr, X, rows: int,
             serial=None) -> torch.Tensor:
    """CSR SpMM that expands the row ids on every call that needs
    them."""
    return csr_spmm_rowids(data, indices,
                           _plain_row_ids(data, indptr, X),
                           X, rows, lengths=indptr[1:] - indptr[:-1],
                           serial=serial, offsets=indptr)


def sliced_ell_pack(data, indices, indptr, rows: int):
    """Row-binned ("sliced") ELL: rows grouped by the next power of two
    of their length, one (rows_bin, W_bin) ELL block per bin, so padding
    stays under 2x nnz whatever the skew (flat ELL pads every row to
    the longest and goes over its budget on one heavy row).

    A tuple of ``(ell_data, ell_cols, ell_counts, row_idx)`` bins in
    ascending W (``row_idx``, int32, maps a bin row back to its row;
    rows with no entry are in no bin), or None for an empty matrix.
    Padded slots repeat the row's last column with value 0, as in
    ``ell_pack``.  Bin membership is computed on the host from indptr
    (one transfer of rows + 1 values, as the JAX package does); the
    block gathers run on the matrix's device."""
    nnz = int(indices.shape[0])
    if nnz == 0 or rows == 0:
        return None
    dev = data.device
    indptr_h = indptr.cpu().numpy()
    counts = (indptr_h[1:] - indptr_h[:-1]).astype(np.int64)
    nzr = counts > 0
    widths = np.ones_like(counts)
    widths[nzr] = 2 ** np.ceil(np.log2(counts[nzr])).astype(np.int64)
    bins = []
    for W in np.unique(widths[nzr]):
        sel = np.nonzero(nzr & (widths == W))[0]
        W = int(W)
        row_idx = torch.from_numpy(sel.astype(np.int32)).to(dev)
        cnt = torch.from_numpy(counts[sel].astype(np.int32)).to(dev)
        ridx = row_idx.to(torch.int64)
        row_start = indptr[ridx]
        row_last = torch.clamp(indptr[ridx + 1] - 1, 0, nnz - 1)
        slot = torch.arange(W, dtype=torch.int32, device=dev)
        src = torch.minimum(row_start[:, None] + slot[None, :],
                            row_last[:, None])
        valid = slot[None, :] < cnt[:, None]
        ell_data = torch.where(valid, data[src],
                               torch.zeros((), dtype=data.dtype, device=dev))
        bins.append((ell_data, indices[src], cnt, row_idx))
    return tuple(bins)


def _sliced_ell_spmv(bins, x, rows: int, f32acc: bool) -> torch.Tensor:
    out_dtype = torch.promote_types(bins[0][0].dtype, x.dtype)
    y = torch.zeros((rows,), dtype=out_dtype, device=x.device)
    for ell_data, ell_cols, cnt, row_idx in bins:
        W = ell_data.shape[1]
        slot = torch.arange(W, dtype=cnt.dtype, device=cnt.device)
        valid = slot[None, :] < cnt[:, None]
        xg = x[gather_index(ell_cols)]
        prod = (ell_data.float() * xg.float() if f32acc
                else ell_data * xg)
        prod = torch.where(valid, prod, torch.zeros((), dtype=prod.dtype,
                                                    device=prod.device))
        y[row_idx.to(torch.int64)] = _row_sum(prod).to(out_dtype)
    return y


def sliced_ell_spmv(bins, x, rows: int) -> torch.Tensor:
    """SpMV over a ``sliced_ell_pack``: one masked ELL row reduction a
    bin, written back to the rows of the bin; rows in no bin stay 0.
    The result is ``result_type(A, x)``."""
    return _sliced_ell_spmv(bins, x, rows, f32acc=False)


# ---- Low-precision storage, f32 accumulation --------------------------
#
# Compressed storage (``csr_array.compress``: bf16 values, int16 column
# indices) against an operand of another dtype.  Each variant widens the
# gathered product to f32 before the reduction, then narrows the result
# to ``result_type(data, x)``: bf16 in, bf16 out; an f32 x gives f32 out
# with no widened copy of the matrix.  Padded slots mask the product,
# never the operand.  Sums over nonzeros run in their stored order
# (``convert.segment_sum``), so the result does not change from call to
# call on the card.


def _row_sum(prod: torch.Tensor) -> torch.Tensor:
    """Sum of each row of a (rows, W) block through ``segment_sum``: in
    slot order on the CPU, as XLA reduces an ELL row there (a tensor
    ``sum`` takes another order), and one segmented reduction on the
    card."""
    rows, W = prod.shape
    lengths = torch.full((rows,), W, dtype=torch.int64, device=prod.device)
    return segment_sum(prod.reshape(-1), lengths)


def _row_lengths(row_ids, rows: int) -> torch.Tensor:
    """``rows + 1`` segment lengths counted from sorted row ids, the
    last the padding id ``rows``'s.  An integer ``index_add_``: no host
    sync (``bincount`` reads its maximum back on CUDA), and the count
    does not depend on order."""
    ids = row_ids.to(torch.int64)
    return torch.zeros((rows + 1,), dtype=torch.int64,
                       device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


# The csr-rowids sums take one of two orders, chosen by the matrix's
# longest row (``csr_array._serial_rows``).  Up to this many stored
# entries a row, one thread sums each row in slot order (a 2-D
# ``segment_reduce``, which on CUDA loops over the segment); longer rows
# make that thread the critical path, and one segmented reduction a row
# (the 1-D ``segment_reduce``, a CUB segmented reduce in tree order)
# takes over.
SERIAL_MAX_ROW = 1024

# Each column of a flattened (k, stride) product starts on a multiple of
# this many elements, so the 1-D segmented reduction meets every
# column's segments at the alignment it meets the SpMV's: on CUDA the
# order in which it sums a segment depends on that alignment.
_COLUMN_ALIGN = 64


def row_sums(prod: torch.Tensor, lengths: torch.Tensor,
             serial=None) -> torch.Tensor:
    """Sums of each run of ``lengths[s]`` consecutive entries of a
    (nnz,) or (nnz, k) float product: the csr-rowids reduction.  Each
    column of a 2-D product is summed exactly as the 1-D product of
    that column would be.  ``serial`` (None: the longest run at most
    ``SERIAL_MAX_ROW``, one host sync) picks the order: slot order in
    one thread a run, or a segmented reduction a run.  On the CPU both
    are slot order.  ``lengths`` come from ``indptr`` or a count of
    sorted row ids, valid by construction, so ``segment_reduce`` skips
    its check of them (a host sync on CUDA)."""
    if serial is None:
        serial = (lengths.numel() == 0
                  or int(lengths.max()) <= SERIAL_MAX_ROW)
    flat = prod.dim() == 1
    if serial:
        vals = prod[:, None] if flat else prod
        if vals.is_complex():
            out = torch.view_as_complex(torch.segment_reduce(
                torch.view_as_real(vals), "sum", lengths=lengths,
                unsafe=True).contiguous())
        else:
            out = torch.segment_reduce(vals, "sum", lengths=lengths,
                                       unsafe=True)
        return out[:, 0] if flat else out
    if flat or prod.shape[1] == 1:
        out = _segment_sum_1d(prod.reshape(-1), lengths)
        return out if flat else out[:, None]
    nnz, k = prod.shape
    nseg = lengths.shape[0]
    stride = -(-max(nnz, 1) // _COLUMN_ALIGN) * _COLUMN_ALIGN
    cols = prod.new_zeros((k, stride))
    cols[:, :nnz] = prod.T
    lens = torch.nn.functional.pad(lengths, (0, 1), value=stride - nnz)
    out = _segment_sum_1d(cols.reshape(-1), lens.repeat(k))
    return out.reshape(k, nseg + 1)[:, :nseg].T


def _segment_sum_1d(vals: torch.Tensor, lengths: torch.Tensor
                    ) -> torch.Tensor:
    if vals.is_complex():
        # (re, im) pairs are a 2-D operand: summed in slot order.
        return row_sums(vals, lengths, serial=True)
    return torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)


def csr_spmv_rowids_f32acc(data, indices, row_ids, x,
                           rows: int) -> torch.Tensor:
    """y = A @ x with products and sums in f32, ``result_type(data, x)``
    out."""
    out_dtype = torch.promote_types(data.dtype, x.dtype)
    prod = data.float() * x[gather_index(indices)].float()
    return segment_sum(prod, _row_lengths(row_ids, rows)[:rows]).to(
        out_dtype)


def csr_spmv_rowids_masked_f32acc(data, indices, row_ids, valid_nnz, x,
                                  rows: int) -> torch.Tensor:
    """``csr_spmv_rowids_f32acc`` over a zero-padded nonzero suffix: the
    slots at or past ``valid_nnz`` contribute an exact 0 (the product is
    masked, not multiplied by 0).  ``row_ids`` are sorted; a padded slot
    may carry the out-of-range id ``rows``, whose sum is dropped, as the
    JAX package's ``segment_sum`` drops it."""
    out_dtype = torch.promote_types(data.dtype, x.dtype)
    slot = torch.arange(data.shape[0], device=data.device)
    prod = torch.where(slot < valid_nnz,
                       data.float() * x[gather_index(indices)].float(),
                       torch.zeros((), dtype=torch.float32,
                                   device=data.device))
    y = segment_sum(prod, _row_lengths(row_ids, rows))
    return y[:rows].to(out_dtype)


def csr_spmm_rowids_f32acc(data, indices, row_ids, X,
                           rows: int) -> torch.Tensor:
    """Y = A @ X (X dense, (cols, k)) with products and sums in f32,
    ``result_type(data, X)`` out."""
    out_dtype = torch.promote_types(data.dtype, X.dtype)
    prod = data.float()[:, None] * X[gather_index(indices), :].float()
    return segment_sum(prod, _row_lengths(row_ids, rows)[:rows]).to(
        out_dtype)


def ell_spmv_f32acc(ell_data, ell_cols, ell_counts, x) -> torch.Tensor:
    """SpMV over an ELL pack: masked f32 products, an f32 row sum,
    ``result_type(ell_data, x)`` out."""
    out_dtype = torch.promote_types(ell_data.dtype, x.dtype)
    W = ell_data.shape[1]
    slot = torch.arange(W, dtype=ell_counts.dtype, device=ell_counts.device)
    valid = slot[None, :] < ell_counts[:, None]
    prod = torch.where(valid,
                       ell_data.float() * x[gather_index(ell_cols)].float(),
                       torch.zeros((), dtype=torch.float32,
                                   device=ell_data.device))
    return _row_sum(prod).to(out_dtype)


def sliced_ell_spmv_f32acc(bins, x, rows: int) -> torch.Tensor:
    """``sliced_ell_spmv`` with f32 products and row sums,
    ``result_type(A, x)`` out."""
    return _sliced_ell_spmv(bins, x, rows, f32acc=True)


def semiring_identity(add: str, dtype: torch.dtype, device=None):
    """Additive identity of a semiring add-op as a 0-d tensor: the value
    a masked slot takes (sum: 0; min: +inf; max: -inf; booleans: or is
    max, identity False)."""
    if add == "sum":
        return torch.zeros((), dtype=dtype, device=device)
    if dtype == torch.bool:
        return torch.tensor(add == "min", dtype=dtype, device=device)
    if dtype.is_floating_point:
        return torch.tensor(math.inf if add == "min" else -math.inf,
                            dtype=dtype, device=device)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if add == "min" else info.min,
                        dtype=dtype, device=device)


def _semiring_product(mul: str, vals, gathered):
    """The per-slot product.  ``and`` is structural (a stored entry is an
    edge, csgraph's explicit-zero convention): the gathered frontier
    bit, whatever the stored value."""
    if mul == "times":
        return vals * gathered
    if mul == "plus":
        return vals + gathered
    if mul == "and":
        return gathered != 0
    raise ValueError(f"unknown semiring multiply {mul!r}")


def _semiring_reduce(prod, row_ids, rows: int, add: str):
    """Reduce the slots of each row (``row_ids`` sorted) by ``add``: a
    segment sum for ``"sum"``, a scatter-min or -max from the identity
    otherwise (order-free, so bit for bit on any device).  Booleans
    count their True slots with integer adds (or: any; and: all), which
    every device reduces; no bool scatter-reduce."""
    if add == "sum":
        lengths = torch.bincount(row_ids.to(torch.int64), minlength=rows)
        return segment_sum(prod, lengths)
    if add not in ("min", "max"):
        raise ValueError(f"unknown semiring add {add!r}")
    idx = row_ids.to(torch.int64)
    shape = (rows,) + tuple(prod.shape[1:])
    if prod.dtype == torch.bool:
        hits = torch.zeros(shape, dtype=torch.int32, device=prod.device)
        hits.index_add_(0, idx, prod.to(torch.int32))
        if add == "max":
            return hits > 0
        total = torch.zeros((rows,), dtype=torch.int32, device=prod.device)
        total.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        return hits == (total if prod.dim() == 1 else total[:, None])
    out = semiring_identity(add, prod.dtype, prod.device).expand(
        shape).clone()
    if prod.dim() == 2:
        idx = idx[:, None].expand_as(prod)
    out.scatter_reduce_(0, idx, prod, "amin" if add == "min" else "amax")
    return out


def csr_semiring_spmv_rowids_masked(data, indices, row_ids, valid_nnz, x,
                                    rows: int, add: str, mul: str):
    """Semiring SpMV over a padded nonzero suffix: slots at or past
    ``valid_nnz`` take the add-op's identity.  ``add="sum",
    mul="times"`` is ``csr_spmv_rowids`` summed in segment order."""
    slot = torch.arange(data.shape[0], device=data.device)
    prod = _semiring_product(mul, data, x[indices.to(torch.int64)])
    prod = torch.where(slot < valid_nnz, prod,
                       semiring_identity(add, prod.dtype, prod.device))
    return _semiring_reduce(prod, row_ids, rows, add)


def csr_semiring_spmm_rowids_masked(data, indices, row_ids, valid_nnz, X,
                                    rows: int, add: str, mul: str):
    """Semiring SpMM (k stacked operand columns, one multi-source sweep):
    column by column ``csr_semiring_spmv_rowids_masked``."""
    slot = torch.arange(data.shape[0], device=data.device)
    prod = _semiring_product(mul, data[:, None],
                             X[indices.to(torch.int64), :])
    prod = torch.where((slot < valid_nnz)[:, None], prod,
                       semiring_identity(add, prod.dtype, prod.device))
    return _semiring_reduce(prod, row_ids, rows, add)


def _plus_times(add: str, mul: str) -> bool:
    """Whether the pair is plus-times: the semiring products then run
    their plus-times sibling, so the two agree bit for bit."""
    return add == "sum" and mul == "times"


def _semiring_row_reduce(prod, add: str):
    """Reduce axis 1 of a (rows, W[, k]) ELL product by the add-op;
    booleans reduce by any/all."""
    if add == "sum":
        return prod.sum(dim=1)
    if add not in ("min", "max"):
        raise ValueError(f"unknown semiring add {add!r}")
    if prod.dtype == torch.bool:
        return prod.any(dim=1) if add == "max" else prod.all(dim=1)
    return prod.amax(dim=1) if add == "max" else prod.amin(dim=1)


def _ell_valid(ell_counts, W: int):
    slot = torch.arange(W, dtype=ell_counts.dtype, device=ell_counts.device)
    return slot[None, :] < ell_counts[:, None]


def ell_semiring_spmv(ell_data, ell_cols, ell_counts, x, add: str,
                      mul: str) -> torch.Tensor:
    """Semiring SpMV over an ELL pack: padded slots' products take the
    add-op's identity, each row reduces by the add-op."""
    if _plus_times(add, mul):
        return ell_spmv(ell_data, ell_cols, ell_counts, x)
    valid = _ell_valid(ell_counts, ell_data.shape[1])
    prod = _semiring_product(mul, ell_data, x[gather_index(ell_cols)])
    prod = torch.where(valid, prod,
                       semiring_identity(add, prod.dtype, prod.device))
    return _semiring_row_reduce(prod, add)


def ell_semiring_spmm(ell_data, ell_cols, ell_counts, X, add: str,
                      mul: str) -> torch.Tensor:
    """``ell_semiring_spmv`` for a dense (cols, k) X (the multi-source
    frontier's per-shard product): the (rows, W, k) product in one pass,
    frontier batches being narrow."""
    if _plus_times(add, mul):
        return ell_spmm(ell_data, ell_cols, ell_counts, X)
    valid = _ell_valid(ell_counts, ell_data.shape[1])
    prod = _semiring_product(mul, ell_data[:, :, None],
                             X[gather_index(ell_cols), :])
    prod = torch.where(valid[:, :, None], prod,
                       semiring_identity(add, prod.dtype, prod.device))
    return _semiring_row_reduce(prod, add)


def sliced_ell_semiring_spmv(bins, x, rows: int, add: str,
                             mul: str) -> torch.Tensor:
    """Semiring SpMV over a ``sliced_ell_pack``: one masked ELL
    reduction a bin, written back to the rows of the bin; rows in no bin
    keep the add-op's identity."""
    if _plus_times(add, mul):
        return sliced_ell_spmv(bins, x, rows)
    probe = _semiring_product(mul, bins[0][0][:1, :1],
                              x[gather_index(bins[0][1][:1, :1])])
    y = semiring_identity(add, probe.dtype, x.device).expand(
        (rows,)).clone()
    for ell_data, ell_cols, cnt, row_idx in bins:
        y[row_idx.to(torch.int64)] = ell_semiring_spmv(
            ell_data, ell_cols, cnt, x, add, mul).to(probe.dtype)
    return y


def coo_spmv_segment(data, row_ids, col_ids, valid_nnz, x,
                     rows: int) -> torch.Tensor:
    """Masked COO SpMV over a power-of-two padded update buffer (the
    delta layer's serving product): slots at or past ``valid_nnz``
    contribute an exact 0 (the product is masked, never ``0*x``), and
    padded slots carry the out-of-range row ``rows``, whose sum is
    dropped.  ``row_ids`` are sorted; each row's entries sum in slot
    order over the rows the buffer touches, which are scattered into
    zeros (one host sync for their count)."""
    slot = torch.arange(data.shape[0], device=data.device)
    prod = torch.where(slot < valid_nnz, data * x[gather_index(col_ids)],
                       torch.zeros((), dtype=data.dtype,
                                   device=data.device))
    uniq, counts = torch.unique_consecutive(row_ids, return_counts=True)
    y = torch.zeros((rows + 1,), dtype=prod.dtype, device=prod.device)
    y[uniq.to(torch.int64)] = segment_sum(prod, counts)
    return y[:rows]
