# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Matrix construction gallery (mirrors ``legate_sparse_tpu/gallery.py``).

- Constructors: ``diags``, ``eye``, ``identity``, ``spdiags``, ``kron``,
  ``kronsum``, ``tril``/``triu``, ``vstack``, ``hstack``,
  ``block_diag``, ``bmat``/``block_array``, and ``find``.
- Generators: ``random``, ``powerlaw`` and ``rmat``.  They draw with
  numpy's ``Generator`` in the JAX package's order, so one seed gives
  the same matrix in both packages, bit for bit; only the finished
  arrays move to the device.

A band is laid out with numpy on the host (scipy's column-aligned DIA
layout, O(num_diags) bookkeeping) and moved to the device once.  The
constructors that take matrices work on the device of their first
operand (a scipy or dense operand goes to the default device); the
others take ``device`` (default: the runtime's default device).
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .dia import dia_array
from .ops.convert import (coo_to_csr, compact_mask, indptr_from_row_ids,
                          row_ids_from_indptr)
from .runtime import default_float, resolve_device
from .types import coord_dtype_for, index_dtype, to_numpy_dtype, to_torch_dtype
from .utils import cast_to_common_type, find_common_type, to_numpy


def diags(diagonals, offsets=0, shape=None, format=None, dtype=None,
          device=None):
    """Construct a sparse matrix from diagonals (scipy.sparse.diags) on
    ``device`` (default: the runtime's default device)."""
    if np.isscalar(offsets) or isinstance(offsets, numbers.Integral):
        if len(diagonals) == 0 or np.isscalar(diagonals[0]):
            diagonals = [diagonals]
        offsets = [offsets]
    offsets = np.atleast_1d(np.asarray(offsets, dtype=np.int64))
    diagonals = [np.atleast_1d(np.asarray(d)) for d in diagonals]
    if len(diagonals) != len(offsets):
        raise ValueError("number of diagonals != number of offsets")
    if len(np.unique(offsets)) != len(offsets):
        raise ValueError("offset array contains duplicate values")
    dev = resolve_device(device)

    if dtype is None:
        np_dtype = np.result_type(*[d.dtype for d in diagonals])
        if not (np.issubdtype(np_dtype, np.floating)
                or np.issubdtype(np_dtype, np.complexfloating)):
            # scipy casts integer diagonals to float.
            np_dtype = to_numpy_dtype(default_float)
        dtype = to_torch_dtype(np_dtype)
    dtype = to_torch_dtype(dtype)
    # bf16 is laid out in f32 (exact for bf16 inputs) and narrowed once.
    np_dtype = to_numpy_dtype(dtype)

    if shape is None:
        m = len(diagonals[0]) + abs(int(offsets[0]))
        shape = (m, m)
    rows, cols = int(shape[0]), int(shape[1])

    data = np.zeros((len(offsets), cols), dtype=np_dtype)
    for j, (diag, off) in enumerate(zip(diagonals, offsets)):
        off = int(off)
        length = min(rows + min(off, 0), cols - max(off, 0))
        if length < 0:
            raise ValueError(
                f"Offset {off} (index {j}) out of bounds for shape {shape}")
        start = max(0, off)
        if diag.shape[0] == 1 and length > 1:
            data[j, start:start + length] = diag[0]
        else:
            if diag.shape[0] != length and not (diag.shape[0] == 1
                                                and length == 1):
                raise ValueError(
                    f"Diagonal length (index {j}: {diag.shape[0]} at offset "
                    f"{off}) does not agree with array size ({rows}, {cols}).")
            data[j, start:start + length] = diag[:length]

    tdata = torch.from_numpy(data).to(device=dev, dtype=dtype)
    result = dia_array((tdata, offsets), shape=(rows, cols))
    if format in (None, "dia"):
        return result
    return result.asformat(format)


def _np_dtype(dtype):
    """(torch dtype, numpy dtype laid out on the host) of a dtype, the
    default float for None (bf16 is laid out in float32)."""
    dtype = to_torch_dtype(default_float if dtype is None else dtype)
    return dtype, to_numpy_dtype(dtype)


def eye(m, n=None, k=0, dtype=None, format=None, device=None):
    """Sparse identity/eye (scipy's ``eye``)."""
    if n is None:
        n = m
    dtype, np_dtype = _np_dtype(dtype)
    length = min(int(m) + min(k, 0), int(n) - max(k, 0))
    if length <= 0:
        return diags([np.zeros(0, dtype=np_dtype)], [0],
                     shape=(int(m), int(n)), format=format, dtype=dtype,
                     device=device)
    return diags([np.ones(length, dtype=np_dtype)], [k],
                 shape=(int(m), int(n)), format=format, dtype=dtype,
                 device=device)


def identity(n, dtype=None, format=None, device=None):
    return eye(n, dtype=dtype, format=format, device=device)


def _as_csr(A, device=None):
    """Any sparse input (a format of this package, scipy) or a dense one
    as a ``csr_array``: the input contract of the free functions."""
    from .csr import csr_array

    if isinstance(A, csr_array):
        return A if device is None else csr_array(A, device=device)
    if hasattr(A, "tocsr"):
        A = A.tocsr()
    if isinstance(A, csr_array):
        return A if device is None else csr_array(A, device=device)
    return csr_array(A, device=device)


def kron(A, B, format=None):
    """Kronecker product (scipy's ``kron``): one outer expansion of the
    two coordinate lists, entry (ra*mB + rb, ca*nB + cb) = va*vb, on A's
    device."""
    from .csr import csr_array

    A = _as_csr(A)._canonicalized()
    B = _as_csr(B, device=A.device)._canonicalized()
    mA, nA = A.shape
    mB, nB = B.shape
    ra, ca, va = A._coo_parts()
    rb, cb, vb = B._coo_parts()
    rows = (ra.to(torch.int64)[:, None] * mB
            + rb.to(torch.int64)[None, :]).reshape(-1)
    cols = (ca.to(torch.int64)[:, None] * nB
            + cb.to(torch.int64)[None, :]).reshape(-1)
    vals = (va[:, None] * vb[None, :]).reshape(-1)
    out = csr_array((vals, (rows, cols)), shape=(mA * mB, nA * nB))
    return out.asformat(format)


def _tri_mask(A, k: int, keep_lower: bool):
    from .csr import csr_array

    A = _as_csr(A)
    row_ids = row_ids_from_indptr(A.indptr, A.nnz)
    d = A.indices.to(index_dtype()) - row_ids
    keep = (d <= k) if keep_lower else (d >= k)
    data, indices, rows_kept = compact_mask(keep, (A.data, A.indices,
                                                   row_ids))
    return csr_array._from_parts(
        data, indices, indptr_from_row_ids(rows_kept, A.shape[0]), A.shape,
        canonical=A._canonical)


def tril(A, k=0, format=None):
    """Lower-triangular part (scipy's ``tril``): the entries with
    ``col - row <= k``, masked on the device."""
    return _tri_mask(A, int(k), keep_lower=True).asformat(format)


def triu(A, k=0, format=None):
    """Upper-triangular part (scipy's ``triu``): ``col - row >= k``."""
    return _tri_mask(A, int(k), keep_lower=False).asformat(format)


def spdiags(data, diags_offsets, m=None, n=None, format=None, device=None):
    """scipy's ``spdiags``: a band from a (nd, n) array in scipy's DIA
    layout (``data[d, j]`` sits in column j)."""
    data = np.atleast_2d(np.asarray(data))
    if not (np.issubdtype(data.dtype, np.floating)
            or np.issubdtype(data.dtype, np.complexfloating)):
        data = data.astype(to_numpy_dtype(default_float))
    if m is None and n is None:
        m = n = data.shape[1]    # scipy >= 1.9 infers a square shape
    if n is None:                # scipy also takes spdiags(data, offs, (m, n))
        m, n = int(m[0]), int(m[1])
    else:
        m, n = int(m), int(n)
    offsets = np.atleast_1d(np.asarray(diags_offsets, dtype=np.int64))
    if data.shape[1] < n:
        data = np.pad(data, ((0, 0), (0, n - data.shape[1])))
    result = dia_array((torch.from_numpy(np.ascontiguousarray(data[:, :n]))
                        .to(resolve_device(device)), offsets), shape=(m, n))
    if format in (None, "dia"):
        return result
    return result.asformat(format)


def _as_csr_list(blocks):
    mats = [_as_csr(b) for b in blocks]
    if not mats:
        raise ValueError("blocks must not be empty")
    dev = mats[0].device
    return [m if m.device == dev else _as_csr(m, device=dev) for m in mats]


def vstack(blocks, format=None, dtype=None):
    """Stack vertically (scipy's ``vstack``): CSR concatenation, the
    indices as they are and indptr offset."""
    from .csr import csr_array

    mats = _as_csr_list(blocks)
    cols = mats[0].shape[1]
    if any(mat.shape[1] != cols for mat in mats):
        raise ValueError("vstack: mismatching number of columns")
    mats = list(cast_to_common_type(*mats))
    parts = [mats[0].indptr]
    offset = mats[0].nnz
    for mat in mats[1:]:
        parts.append(mat.indptr[1:] + offset)
        offset += mat.nnz
    out = csr_array._from_parts(
        torch.cat([mat.data for mat in mats]),
        torch.cat([mat.indices for mat in mats]), torch.cat(parts),
        (sum(mat.shape[0] for mat in mats), cols),
        canonical=all(mat.has_canonical_format for mat in mats))
    if dtype is not None:
        out = out.astype(dtype)
    return out.asformat(format)


def hstack(blocks, format=None, dtype=None):
    """Stack horizontally (scipy's ``hstack``): the coordinate lists
    joined with column offsets, sorted stably by row."""
    from .csr import csr_array

    mats = _as_csr_list(blocks)
    rows = mats[0].shape[0]
    if any(mat.shape[0] != rows for mat in mats):
        raise ValueError("hstack: mismatching number of rows")
    mats = list(cast_to_common_type(*mats))
    cols = sum(mat.shape[1] for mat in mats)
    cdt = coord_dtype_for(max(rows, cols))
    rr, cc, vv = [], [], []
    offset = 0
    for mat in mats:
        r, c, v = mat._coo_parts()
        rr.append(r.to(cdt))
        cc.append(c.to(cdt) + offset)
        vv.append(v)
        offset += mat.shape[1]
    data, indices, indptr = coo_to_csr(torch.cat(rr), torch.cat(cc),
                                       torch.cat(vv), rows)
    # The blocks hold disjoint column ranges in order, so the result is
    # canonical exactly when every block is (the stable row sort keeps
    # each block's column order); else unknown.
    out = csr_array._from_parts(
        data, indices, indptr, (rows, cols),
        canonical=(True if all(m.has_canonical_format for m in mats)
                   else None))
    if dtype is not None:
        out = out.astype(dtype)
    return out.asformat(format)


def block_diag(mats, format=None, dtype=None):
    """Block-diagonal matrix (scipy's ``block_diag``)."""
    from .csr import csr_array

    mats = _as_csr_list(mats)
    cols = sum(mat.shape[1] for mat in mats)
    cdt = coord_dtype_for(cols)
    padded = []
    col_before = 0
    for mat in mats:
        m_i, n_i = mat.shape
        padded.append(csr_array._from_parts(
            mat.data, mat.indices.to(cdt) + col_before, mat.indptr,
            (m_i, cols), canonical=mat._canonical))
        col_before += n_i
    out = vstack(padded)
    if dtype is not None:
        out = out.astype(dtype)
    return out.asformat(format)


def _generator(rng):
    return rng if isinstance(rng, np.random.Generator) else \
        np.random.default_rng(rng)


def _from_sampled(vals, rows, cols, shape, dtype, format, device):
    """The CSR matrix of sampled (possibly repeated) coordinates, sorted
    by (row, col) on the host as the JAX package does, then built on the
    device (duplicates kept, as COO input is)."""
    from .csr import csr_array

    order = np.lexsort((cols, rows))
    A = csr_array((torch.from_numpy(vals[order]).to(dtype),
                   (rows[order], cols[order])), shape=shape,
                  device=resolve_device(device))
    return A.asformat(format)


def random(m, n, density=0.01, format="coo", dtype=None, rng=None,
           random_state=None, data_rvs=None, device=None):
    """Random sparse matrix (scipy's ``random`` signature, the legacy
    ``random_state=`` and ``data_rvs`` included); the default
    ``format="coo"`` returns a ``coo_array``, as scipy does."""
    m, n = int(m), int(n)
    if not 0 <= density <= 1:
        raise ValueError("density expected to be 0 <= density <= 1")
    rng = _generator(random_state if rng is None else rng)
    nnz = min(int(round(density * m * n)), m * n)
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows = (flat // n).astype(np.int64)
    cols = (flat % n).astype(np.int64)
    dtype, np_dtype = _np_dtype(dtype)
    if data_rvs is not None:
        vals = np.asarray(data_rvs(nnz)).astype(np_dtype)
    elif np.issubdtype(np_dtype, np.integer):
        # scipy samples random integers for integer dtypes.
        vals = rng.integers(np.iinfo(np_dtype).min, np.iinfo(np_dtype).max,
                            size=nnz).astype(np_dtype)
    elif np.issubdtype(np_dtype, np.complexfloating):
        vals = (rng.random(nnz) + 1j * rng.random(nnz)).astype(np_dtype)
    else:
        vals = rng.random(nnz).astype(np_dtype)
    return _from_sampled(vals, rows, cols, (m, n), dtype, format, device)


def powerlaw(m, n=None, nnz_per_row=8, alpha=1.8, rng=None, format="csr",
             dtype=None, directed=True, device=None):
    """Power-law random sparse matrix: row i holds
    ``min(nnz_per_row * Zipf(alpha), n)`` entries at uniform columns
    (heavy-tailed out-degrees).  ``directed=False`` stores each sampled
    edge both ways (square only).  Duplicate coordinates are kept."""
    m = int(m)
    n = m if n is None else int(n)
    rng = _generator(rng)
    counts = np.minimum(nnz_per_row * rng.zipf(alpha, size=m),
                        n).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), counts)
    nnz = int(counts.sum())
    cols = rng.integers(0, n, size=nnz)
    dtype, np_dtype = _np_dtype(dtype)
    vals = rng.random(nnz).astype(np_dtype)
    if not directed:
        if m != n:
            raise ValueError(
                "powerlaw: directed=False requires a square matrix")
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
        vals = np.concatenate([vals, vals])
    return _from_sampled(vals, rows, cols, (m, n), dtype, format, device)


def rmat(scale, nnz_per_row=8, a=0.57, b=0.19, c=0.19, rng=None,
         format="csr", dtype=None, directed=True, device=None):
    """R-MAT random graph (Graph500's defaults): ``2**scale`` square with
    ``nnz_per_row * 2**scale`` edges, each placed by ``scale`` quadrant
    choices with probabilities (a, b, c, 1-a-b-c).  ``directed=False``
    stores each edge both ways.  Duplicate edges are kept."""
    scale = int(scale)
    m = 1 << scale
    d = 1.0 - a - b - c
    if d < 0 or min(a, b, c) < 0:
        raise ValueError(f"quadrant probabilities ({a}, {b}, {c}, {d}) "
                         f"must be non-negative")
    rng = _generator(rng)
    nnz = int(nnz_per_row) * m
    rows = np.zeros(nnz, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int64)
    for _ in range(scale):
        u1 = rng.random(nnz)
        u2 = rng.random(nnz)
        # Top or bottom half by P(bottom) = c + d, then left or right
        # given the row half.
        row_bit = u1 >= a + b
        p_right = np.where(row_bit, d / max(c + d, 1e-300),
                           b / max(a + b, 1e-300))
        col_bit = u2 < p_right
        rows = rows * 2 + row_bit
        cols = cols * 2 + col_bit
    dtype, np_dtype = _np_dtype(dtype)
    vals = rng.random(nnz).astype(np_dtype)
    if not directed:
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
        vals = np.concatenate([vals, vals])
    return _from_sampled(vals, rows, cols, (m, m), dtype, format, device)


def find(A):
    """(row, col, values) of the nonzero entries (scipy's ``find``):
    duplicates summed, stored zeros dropped, as numpy arrays in
    row-major order."""
    A = _as_csr(A)._canonicalized()
    r, c, v = A._coo_parts()
    return tuple(to_numpy(t) for t in compact_mask(v != 0, (r, c, v)))


def bmat(blocks, format=None, dtype=None):
    """A matrix from a 2-D grid of sparse blocks (scipy's ``bmat``);
    ``None`` is a zero block whose shape its row and column give."""
    from .csr import csr_array

    rows_in = [list(r) for r in blocks]
    if not rows_in or not rows_in[0]:
        raise ValueError("blocks must be a non-empty 2-D grid")
    R, C = len(rows_in), len(rows_in[0])
    if any(len(r) != C for r in rows_in):
        raise ValueError("blocks must have uniform row lengths")
    heights = [None] * R
    widths = [None] * C
    mats = [[None] * C for _ in range(R)]
    dev = None
    for i in range(R):
        for j in range(C):
            blk = rows_in[i][j]
            if blk is None:
                continue
            mat = _as_csr(blk, device=dev)
            dev = mat.device
            mats[i][j] = mat
            h, w = mat.shape
            if heights[i] is None:
                heights[i] = h
            elif heights[i] != h:
                raise ValueError(f"blocks[{i},:] have incompatible row "
                                 f"counts")
            if widths[j] is None:
                widths[j] = w
            elif widths[j] != w:
                raise ValueError(f"blocks[:,{j}] have incompatible column "
                                 f"counts")
    if any(h is None for h in heights) or any(w is None for w in widths):
        raise ValueError(
            "every block row and column needs at least one non-None block")
    # Zero blocks take the common dtype of the given blocks (scipy
    # infers the dtype from those alone).
    common = find_common_type(*[mat for row in mats for mat in row
                                if mat is not None])
    out = vstack([hstack([
        mats[i][j] if mats[i][j] is not None
        else csr_array((heights[i], widths[j]), dtype=common, device=dev)
        for j in range(C)]) for i in range(R)])
    if dtype is not None:
        out = out.astype(dtype)
    return out.asformat(format)


def block_array(blocks, *, format=None, dtype=None):
    """scipy's ``block_array``: ``bmat`` with keyword-only options."""
    return bmat(blocks, format=format, dtype=dtype)


def kronsum(A, B, format=None):
    """Kronecker sum ``kron(I_m, A) + kron(B, I_n)`` for square A (n x n)
    and B (m x m) (scipy's ``kronsum``)."""
    A = _as_csr(A)
    B = _as_csr(B, device=A.device)
    if A.shape[0] != A.shape[1]:
        raise ValueError("A is not square")
    if B.shape[0] != B.shape[1]:
        raise ValueError("B is not square")
    L = kron(identity(B.shape[0], dtype=A.dtype, device=A.device), A)
    R = kron(B, identity(A.shape[0], dtype=B.dtype, device=A.device))
    return (L + R).asformat(format)
