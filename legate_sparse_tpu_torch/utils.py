# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Tensor utilities: dtype coercion, ``out=`` filling, input adoption.

Mirrors the parts of ``legate_sparse_tpu/utils.py`` that the vector
branch of ``csr_array.dot`` uses (``require_supported_dtype``,
``cast_to_common_type``, ``fill_out``), plus the one place where
numpy and Python inputs become tensors on a device.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .runtime import resolve_device
from .types import SUPPORTED_DATATYPES, to_numpy_dtype, to_torch_dtype


def is_sparse_matrix(o: Any) -> bool:
    from .base import CompressedBase

    return isinstance(o, CompressedBase)


def find_common_type(*dtypes: torch.dtype) -> torch.dtype:
    """numpy's ``result_type`` over torch dtypes (what the JAX package
    applies); bf16 follows PyTorch's promotion, as ``jnp`` does."""
    if any(d == torch.bfloat16 for d in dtypes):
        out = dtypes[0]
        for d in dtypes[1:]:
            out = torch.promote_types(out, d)
        return out
    return to_torch_dtype(np.result_type(*[to_numpy_dtype(d)
                                           for d in dtypes]))


def cast_to_common_type(A, x: torch.Tensor) -> Tuple[Any, torch.Tensor]:
    """Cast a sparse matrix and a dense operand to their common dtype
    (reference ``utils.py:106-114``); an operand already of that dtype
    is returned as it is."""
    common = find_common_type(A.dtype, x.dtype)
    return A.astype(common, copy=False), x.to(common)


def require_supported_dtype(dtype: torch.dtype) -> None:
    if dtype not in SUPPORTED_DATATYPES:
        raise NotImplementedError(
            f"Operation not supported for dtype {dtype}; supported: "
            f"{[str(d) for d in SUPPORTED_DATATYPES]}"
        )


def fill_out(result: torch.Tensor, out, check_shape: bool = True):
    """``out=`` contract: a tensor or numpy ``out`` is filled in place
    and returned; without one the result is returned."""
    if out is None:
        return result
    if check_shape and tuple(out.shape) != tuple(result.shape):
        raise ValueError(f"out shape {tuple(out.shape)} != result "
                         f"{tuple(result.shape)}")
    if isinstance(out, np.ndarray):
        np.copyto(out, to_numpy(result).astype(out.dtype, copy=False))
        return out
    out.copy_(result)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor (bf16 widens to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def device_of(device, *args) -> torch.device:
    """The device a constructor builds on: the one named, else that of
    the first tensor argument, else the default device."""
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor, a numpy array (JAX's bf16
    arrays included) or a nested sequence."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if not arr.flags.writeable:     # e.g. a view of a JAX array
            arr = arr.copy()
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(
                np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
            ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        x = t
    if dtype is not None:
        dtype = to_torch_dtype(dtype)
    return x.to(device=device, dtype=dtype)
