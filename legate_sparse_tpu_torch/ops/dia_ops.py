# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Banded (DIA) structure detection and the plain-PyTorch DIA SpMV.

Mirrors ``legate_sparse_tpu/ops/dia_ops.py``: ``band_cover``
(``:174``), ``csr_band_offsets`` (``:187``), ``dia_from_csr``
(``:212``) and ``dia_spmv_nopad`` (``:105``).  ``dia_spmv_nopad`` is
the DIA path for the value types the CUDA kernel does not take
(f64, complex); f32 and bf16 go through ``dia_kernel``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..types import index_dtype


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
