# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Canonical dtypes for legate_sparse_tpu_torch.

Mirrors ``legate_sparse_tpu/types.py``: the same supported value types
(f32/f64/c64/c128, plus bf16 storage) and the same coordinate policy
(int32 coordinates unless an extent needs int64, int64 indptr/nnz).

The JAX package narrows every index to int32 in processes without x64;
PyTorch has int64 on every device, so here ``index_dtype`` is always
int64 and only ``coord_dtype_for`` picks a width by extent.
"""

from __future__ import annotations

import numpy as np
import torch

try:  # scipy's own class, so ``pytest.warns`` and filters match both
    from scipy.sparse import SparseEfficiencyWarning
except ImportError:  # pragma: no cover
    class SparseEfficiencyWarning(UserWarning):
        """An operation whose result is dense-shaped or needs a
        structure change (scipy's warning class)."""

# Default coordinate type; promoted to int64 for extents past int32.
coord_ty = torch.int32
wide_coord_ty = torch.int64
# indptr / nnz counts.
nnz_ty = torch.int64

# The JAX module's dtype aliases: numpy dtypes, as there.
float32 = np.dtype(np.float32)
float64 = np.dtype(np.float64)
int32 = np.dtype(np.int32)
int64 = np.dtype(np.int64)
uint64 = np.dtype(np.uint64)
complex64 = np.dtype(np.complex64)
complex128 = np.dtype(np.complex128)

SUPPORTED_DATATYPES = (
    torch.bfloat16,
    torch.float32,
    torch.float64,
    torch.complex64,
    torch.complex128,
)

_INT32_MAX = int(np.iinfo(np.int32).max)
_INT64_MAX = int(np.iinfo(np.int64).max)

_NUMPY_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NUMPY = {v: k for k, v in _NUMPY_TO_TORCH.items()}


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype, a Python type or
    a name ("bfloat16" included; numpy has no bf16 of its own)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    nd = np.dtype(dtype)
    if nd.name == "bfloat16":      # ml_dtypes' bf16, as JAX hands it out
        return torch.bfloat16
    try:
        return _NUMPY_TO_TORCH[nd]
    except KeyError:
        raise TypeError(f"no torch dtype for {nd}") from None


def to_numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype; bf16 maps to float32, the
    narrowest numpy type that holds every bf16 value exactly."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return _TORCH_TO_NUMPY[dtype]


def index_dtype() -> torch.dtype:
    """Wide index dtype for row ids, offsets and counters."""
    return nnz_ty


nnz_dtype = index_dtype


def check_nnz(nnz: int) -> None:
    """Loud failure for an nnz no index type here can hold."""
    if nnz > _INT64_MAX:
        raise OverflowError(f"nnz={nnz} exceeds int64")


def coord_dtype_for(extent: int) -> torch.dtype:
    """int32 unless ``extent`` (a dimension or nnz) needs int64."""
    if extent <= _INT32_MAX:
        return coord_ty
    check_nnz(extent)
    return wide_coord_ty
