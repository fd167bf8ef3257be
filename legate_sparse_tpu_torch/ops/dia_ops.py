# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Banded (DIA) structure detection and the plain-PyTorch DIA SpMV,
SpMM and SpGEMM.

Mirrors ``legate_sparse_tpu/ops/dia_ops.py``: ``band_cover``
(``:174``), ``csr_band_offsets`` (``:187``), ``dia_from_csr``
(``:212``), ``dia_spmv_nopad`` (``:105``), ``dia_spmm_masked``
(``:258``), ``dia_spmm`` (``:282``), ``band_product_offsets``
(``:324``), ``band_product_is_full`` (``:330``) and ``band_to_csr``
with ``_band_rows_gather`` (``:399-491``).  The SpMV and SpMM here are
the ``"dia-torch"`` routes: the DIA paths for what the CUDA kernels of
``dia_kernel`` decline (f64 and complex, a dense operand wider than
``SPMM_MAX_K``).  They read scipy's layout, which the kernels' plain
versions, over the row-aligned pack, do not.  The ``"dia-torch"``
SpGEMM is ``dia_kernel.dia_spgemm_plain``: its kernel reads scipy's
layout too.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..types import coord_dtype_for, index_dtype, nnz_dtype
from . import dia_kernel as _dia_kernel
from .convert import row_ids_from_indptr


def _band_reach(offsets: Tuple[int, ...]) -> Tuple[int, int]:
    """(P, Q): band reach below/above the main diagonal."""
    return max(0, -min(offsets)), max(0, max(offsets))


def band_cover(offsets: Tuple[int, ...], shape: Tuple[int, int],
               width: int) -> int:
    """Number of in-bounds band slots for the given diagonals."""
    rows, cols = shape
    total = 0
    for off in offsets:
        j_lo = max(0, off)
        j_hi = min(min(cols, width), rows + off)
        total += max(0, j_hi - j_lo)
    return total


def csr_band_offsets(indices, row_ids,
                     max_diags: int) -> Optional[Tuple[int, ...]]:
    """Distinct diagonals (col - row) of a CSR structure, ascending, or
    None when there are more than ``max_diags`` of them."""
    if indices.shape[0] == 0:
        return None
    d = indices.to(index_dtype()) - row_ids.to(index_dtype())
    offs = torch.unique(d, sorted=True)
    if offs.shape[0] > max_diags:
        return None
    return tuple(int(o) for o in offs.tolist())


def dia_from_csr(data, indices, row_ids, offsets: Tuple[int, ...],
                 cols: int, with_mask: bool = False):
    """Scatter CSR values into scipy-layout DIA storage
    (``dia_data[d, j] = A[j - offsets[d], j]``).  With ``with_mask``,
    also the explicit-entry mask (True where a CSR nonzero exists), so
    kernels skip band holes."""
    offs = torch.tensor(offsets, dtype=index_dtype(), device=data.device)
    d = indices.to(index_dtype()) - row_ids.to(index_dtype())
    d_idx = torch.searchsorted(offs, d)
    col = indices.to(torch.int64)
    out = torch.zeros((len(offsets), cols), dtype=data.dtype,
                      device=data.device)
    out[d_idx, col] = data
    if not with_mask:
        return out
    mask = torch.zeros((len(offsets), cols), dtype=torch.bool,
                       device=data.device)
    mask[d_idx, col] = True
    return out, mask


def dia_spmv(data, x, offsets: Tuple[int, ...],
             shape: Tuple[int, int]) -> torch.Tensor:
    """y = A @ x over scipy-layout DIA storage (``A[j-off, j] =
    data[d, j]``), every slot explicit."""
    return dia_spmv_nopad(data, None, x, offsets, shape)


def dia_spmv_nopad(data, mask, x, offsets: Tuple[int, ...],
                   shape: Tuple[int, int]) -> torch.Tensor:
    """y = A @ x over scipy-layout DIA storage, interior/edge split.

    Interior rows (every offset in range) read ``data`` and ``x``
    through same-length slices; only the rows within the band reach of
    either end take the bounded per-diagonal form.  At a hole (``mask``
    False) x is zeroed before the multiply, so a non-finite x entry
    there never injects NaN."""
    rows, cols = shape
    width = data.shape[1]
    P, Q = _band_reach(offsets)
    i0 = min(P, rows)
    i1 = max(min(rows, min(cols, width) - Q), i0)
    dt = torch.promote_types(data.dtype, x.dtype)
    zero = torch.zeros((), dtype=dt, device=x.device)

    def edge(r0: int, r1: int) -> torch.Tensor:
        ye = torch.zeros((r1 - r0,), dtype=dt, device=x.device)
        for d, off in enumerate(offsets):
            j_lo = max(r0 + off, 0, off)
            j_hi = min(r1 + off, min(cols, width), rows + off)
            if j_hi <= j_lo:
                continue
            contrib = data[d, j_lo:j_hi] * x[j_lo:j_hi]
            if mask is not None:
                contrib = torch.where(mask[d, j_lo:j_hi], contrib, zero)
            ye[j_lo - off - r0: j_hi - off - r0] += contrib
        return ye

    if i1 <= i0:
        return edge(0, rows)

    y_int = torch.zeros((i1 - i0,), dtype=dt, device=x.device)
    for d, off in enumerate(offsets):
        lo, hi = i0 + off, i1 + off
        xv = x[lo:hi]
        if mask is not None:
            xv = torch.where(mask[d, lo:hi], xv,
                             torch.zeros((), dtype=x.dtype, device=x.device))
        y_int = y_int + data[d, lo:hi] * xv

    parts = []
    if i0 > 0:
        parts.append(edge(0, i0))
    parts.append(y_int)
    if i1 < rows:
        parts.append(edge(i1, rows))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def dia_spmm(data, X, offsets: Tuple[int, ...],
             shape: Tuple[int, int]) -> torch.Tensor:
    """Y = A @ X for dense X (cols, k): one shifted add per diagonal."""
    return dia_spmm_masked(data, None, X, offsets, shape)


def dia_spmm_masked(data, mask, X, offsets: Tuple[int, ...],
                    shape: Tuple[int, int]) -> torch.Tensor:
    """Y = A @ X over a band with holes: where ``mask`` is False the
    product is an exact 0, so a non-finite X row there never reaches
    Y.  ``mask=None`` is an exact band."""
    rows, cols = shape
    width = data.shape[1]
    dt = torch.promote_types(data.dtype, X.dtype)
    Y = torch.zeros((rows, X.shape[1]), dtype=dt, device=X.device)
    zero = torch.zeros((), dtype=dt, device=X.device)
    for d, off in enumerate(offsets):
        j_lo = max(0, off)
        j_hi = min(min(cols, width), rows + off)
        if j_hi <= j_lo:
            continue
        contrib = data[d, j_lo:j_hi, None] * X[j_lo:j_hi, :]
        if mask is not None:
            contrib = torch.where(mask[d, j_lo:j_hi, None], contrib, zero)
        Y[j_lo - off:j_hi - off] += contrib
    return Y


# The JAX package's plain DIA SpGEMM: here it is the SpGEMM kernel's plain
# version.
dia_spgemm = _dia_kernel.dia_spgemm_plain


def band_product_offsets(offs_a: Tuple[int, ...],
                         offs_b: Tuple[int, ...]) -> Tuple[int, ...]:
    """Diagonals of C = A @ B for banded operands: the Minkowski sum."""
    return tuple(sorted({oa + ob for oa in offs_a for ob in offs_b}))


def band_product_is_full(offs_a, offs_b, offs_c, shape_a, shape_b) -> bool:
    """True when every in-bounds slot of the product band is reached by
    some (oa, ob) pair, so the full-band result has exactly the pattern
    of the structural (ESC) product.  At the matrix edges a slot can be
    in bounds yet unreachable (A = {-1}, B = {+1}: slot (0, 0)); such a
    product takes ESC, for scipy's pattern."""
    m, k = shape_a
    _, n = shape_b
    by_oc: dict = {o: [] for o in offs_c}
    for oa in offs_a:
        for ob in offs_b:
            j_lo = max(0, ob, oa + ob)
            j_hi = min(n, k + ob, m + oa + ob)
            if j_hi > j_lo:
                by_oc[oa + ob].append((j_lo, j_hi))
    for oc in offs_c:
        want_lo, want_hi = max(0, oc), min(n, m + oc)
        if want_hi <= want_lo:
            continue
        covered = want_lo
        for lo, hi in sorted(by_oc[oc]):
            if lo > covered:
                return False
            covered = max(covered, hi)
        if covered < want_hi:
            return False
    return True


def _band_rows_gather(dia_data, offs, cols: int, r0: int, r1: int,
                      nnz_seg: int):
    """Ragged CSR extraction of band rows [r0, r1): the gather form,
    used for the edge rows only (see ``band_to_csr``)."""
    dev = dia_data.device
    i = torch.arange(r0, r1, dtype=torch.int64, device=dev)
    lo = torch.searchsorted(offs, -i, side="left")
    hi = torch.searchsorted(offs, cols - i, side="left")
    ip_seg = torch.zeros((r1 - r0 + 1,), dtype=torch.int64, device=dev)
    torch.cumsum(hi - lo, 0, out=ip_seg[1:])
    rid = row_ids_from_indptr(ip_seg, nnz_seg)
    pos = torch.arange(nnz_seg, dtype=torch.int64, device=dev) - ip_seg[rid]
    d_idx = lo[rid] + pos
    col = (rid + r0) + offs[d_idx]
    return dia_data[d_idx, col], col


def band_to_csr(dia_data, offsets: Tuple[int, ...], shape: Tuple[int, int],
                nnz: int):
    """Full-band DIA (sorted offsets, width cols) -> CSR triple keeping
    every in-bounds band slot, explicit zeros included;
    ``nnz = band_cover(offsets, shape, cols)``.  Rows come out
    canonical.  Interior rows (every offset in range) hold W entries
    each: their values are W slices of the band stacked row-major and
    their columns an iota sum.  Only the edge rows within the band's
    reach go through the ragged gather."""
    rows, cols = shape
    W = len(offsets)
    dev = dia_data.device
    offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
    i = torch.arange(rows, dtype=torch.int64, device=dev)
    lo = torch.searchsorted(offs, -i, side="left")
    hi = torch.searchsorted(offs, cols - i, side="left")
    indptr = torch.zeros((rows + 1,), dtype=nnz_dtype(), device=dev)
    torch.cumsum(hi - lo, 0, out=indptr[1:])
    col_dtype = coord_dtype_for(max(rows, cols))
    del i, lo, hi

    i0 = min(max(0, -offsets[0]), rows)
    i1 = min(rows, max(cols - offsets[-1], 0))
    if i1 <= i0:
        vals, col = _band_rows_gather(dia_data, offs, cols, 0, rows, nnz)
        return vals, col.to(col_dtype), indptr

    nnz_top = sum(max(0, min(i0, cols - o) - max(0, -o)) for o in offsets)
    nnz_bot = nnz - nnz_top - (i1 - i0) * W
    ar = torch.arange(i0, i1, dtype=col_dtype, device=dev)
    vals_in = torch.stack([dia_data[d, i0 + o:i1 + o]
                           for d, o in enumerate(offsets)], dim=1).reshape(-1)
    cols_in = (ar[:, None] + offs.to(col_dtype)[None, :]).reshape(-1)
    parts_v: List[torch.Tensor] = []
    parts_c: List[torch.Tensor] = []
    if nnz_top:
        v_t, c_t = _band_rows_gather(dia_data, offs, cols, 0, i0, nnz_top)
        parts_v.append(v_t)
        parts_c.append(c_t.to(col_dtype))
    parts_v.append(vals_in)
    parts_c.append(cols_in)
    if nnz_bot:
        v_b, c_b = _band_rows_gather(dia_data, offs, cols, i1, rows, nnz_bot)
        parts_v.append(v_b)
        parts_c.append(c_b.to(col_dtype))
    if len(parts_v) == 1:
        return vals_in, cols_in, indptr
    return torch.cat(parts_v), torch.cat(parts_c), indptr
