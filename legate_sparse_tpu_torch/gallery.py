# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Matrix construction gallery: ``diags`` (mirrors
``legate_sparse_tpu/gallery.py:27``, scipy's ``diags``).

The band is laid out with numpy on the host (scipy's column-aligned
DIA layout, O(num_diags) bookkeeping) and moved to the device once."""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .dia import dia_array
from .runtime import default_float, resolve_device
from .types import to_numpy_dtype, to_torch_dtype


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
