# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Matrix Market and npz input and output.

Mirrors ``legate_sparse_tpu/io.py``: ``mmread`` (``:72-112``) reads
``coordinate`` matrices with real, integer or pattern values and
general, symmetric or skew-symmetric symmetry (off-diagonal entries of
a symmetric file mirrored, negated when skew) into a ``csr_array``;
``mmwrite`` (``:115-130``) writes ``coordinate real general``;
``save_npz``/``load_npz`` (``:133-203``) use scipy's container, with
bf16 values stored as their raw 16-bit patterns beside a dtype marker
(``:153-160``), so they round-trip bit for bit.

Two parser tiers, both on the host: the native C++ parser
(``utils_native``, ``src/mtx_reader.cc``) when its library is loaded,
else numpy.  The COO → CSR build runs on the matrix's device, through
the constructor's stable sort by row: entries keep the file's order
within a row (the native tier puts a mirrored entry right after its
original, the numpy tier after all of them) and duplicates stay.
"""

from __future__ import annotations

import numpy as np
import torch

from .csr import csr_array
from .runtime import resolve_device
from .utils import to_numpy


def _parse_mtx_host(path: str):
    """``(m, n, rows, cols, vals)`` of a coordinate Matrix Market file,
    by numpy (the JAX package's parser, ``:26-69``)."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            raise ValueError(f"{path}: not a MatrixMarket file")
        _, obj, fmt, field, symmetry = header[:5]
        if obj != "matrix" or fmt != "coordinate":
            raise NotImplementedError(
                f"only 'matrix coordinate' supported, got {obj} {fmt}")
        if field not in ("real", "integer", "pattern", "double"):
            raise NotImplementedError(f"unsupported field {field}")
        if symmetry not in ("general", "symmetric", "skew-symmetric"):
            raise NotImplementedError(f"unsupported symmetry {symmetry}")
        line = f.readline()
        while line.startswith(b"%"):
            line = f.readline()
        m, n, nnz = (int(tok) for tok in line.split())
        raw = np.loadtxt(f, ndmin=2) if nnz > 0 else np.zeros((0, 3))
    if nnz == 0:
        r0 = np.zeros(0, dtype=np.int64)
        c0 = np.zeros(0, dtype=np.int64)
        v0 = np.zeros(0, dtype=np.float64)
    else:
        r0 = raw[:, 0].astype(np.int64) - 1
        c0 = raw[:, 1].astype(np.int64) - 1
        v0 = (np.ones(raw.shape[0], dtype=np.float64) if field == "pattern"
              else raw[:, 2].astype(np.float64))
    if symmetry in ("symmetric", "skew-symmetric"):
        off = r0 != c0
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        return (m, n, np.concatenate([r0, c0[off]]),
                np.concatenate([c0, r0[off]]),
                np.concatenate([v0, sign * v0[off]]))
    return m, n, r0, c0, v0


def _parse(path: str):
    from .utils_native import native_mtx_read

    parsed = native_mtx_read(path)
    return parsed if parsed is not None else _parse_mtx_host(path)


def mmread(source, device=None) -> csr_array:
    """A Matrix Market file as a float64 ``csr_array`` on ``device``
    (default: the default device): the native parser when its library
    is loaded, else numpy, then the COO → CSR build on the device."""
    m, n, rows, cols, vals = _parse(str(source))
    return csr_array((vals, (rows, cols)), shape=(m, n),
                     device=resolve_device(device))


def mmwrite(target, a) -> None:
    """Write a sparse matrix as ``matrix coordinate real general``, one
    entry a line, values with 17 significant digits (so a float32 or
    float64 value reads back exactly)."""
    from .gallery import _as_csr

    a = _as_csr(a)
    if a.dtype.is_complex:
        raise TypeError("mmwrite writes real values; got "
                        f"{a.dtype}")
    rows, cols, vals = (to_numpy(t) for t in a._coo_parts())
    with open(str(target), "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {a.nnz}\n")
        step = 1 << 20
        for lo in range(0, rows.shape[0], step):
            f.write("".join(
                f"{r + 1} {c + 1} {v:.17g}\n" for r, c, v in zip(
                    rows[lo:lo + step].tolist(), cols[lo:lo + step].tolist(),
                    vals[lo:lo + step].astype(np.float64).tolist())))


def save_npz(file, matrix, compressed: bool = True) -> None:
    """A matrix in scipy's ``save_npz`` container (CSR).  bf16 values go
    as their raw 16-bit patterns with a ``data_dtype`` marker: numpy
    has no portable bf16, and scipy cannot read such a file (widen
    before saving for scipy)."""
    from .gallery import _as_csr

    matrix = _as_csr(matrix)
    data = matrix.data
    arrays = dict(
        format=np.array(b"csr"),
        shape=np.asarray(matrix.shape, dtype=np.int64),
        data=(to_numpy(data.view(torch.int16)).view(np.uint16)
              if data.dtype == torch.bfloat16 else to_numpy(data)),
        indices=to_numpy(matrix.indices),
        indptr=to_numpy(matrix.indptr),
    )
    if data.dtype == torch.bfloat16:
        arrays["data_dtype"] = np.array(b"bfloat16")
    if compressed:
        np.savez_compressed(file, **arrays)
    else:
        np.savez(file, **arrays)


def load_npz(file, device=None) -> csr_array:
    """A scipy ``save_npz`` container as a ``csr_array`` on ``device``
    (default: the default device).  A CSR container is read directly
    (bf16 values from their raw patterns, bit for bit; indices narrower
    than the coordinate dtype, as compressed storage saves them, keep
    their width); other formats are decoded by scipy and converted."""
    dev = resolve_device(device)
    with np.load(file) as f:
        fmt = f["format"].item()
        if isinstance(fmt, bytes):
            fmt = fmt.decode()
        if fmt == "csr":
            data = f["data"]
            if "data_dtype" in f:
                marker = f["data_dtype"].item().decode()
                if marker != "bfloat16":
                    raise ValueError(f"unknown data_dtype {marker!r}")
                data = torch.from_numpy(
                    data.view(np.int16).copy()).view(torch.bfloat16)
            out = csr_array((data, f["indices"], f["indptr"]),
                            shape=tuple(int(s) for s in f["shape"]),
                            device=dev)
            idx_dt = f["indices"].dtype
            if (idx_dt.kind == "i"
                    and idx_dt.itemsize < out.indices.element_size()):
                # The triple constructor widens indices to the coordinate
                # dtype; restore the container's compressed width
                # (``csr_array.compress``), so storage round-trips
                # exactly (reference ``io.py:189-195``).
                out = out.astype_storage(indices=idx_dt)
            return out
    if hasattr(file, "seek"):
        file.seek(0)
    import scipy.sparse as _ss

    return csr_array(_ss.load_npz(file).tocsr(), device=dev)
