# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Tensor utilities: dtype coercion, ``out=`` filling, input adoption.

Mirrors ``legate_sparse_tpu/utils.py`` (``find_common_type``,
``cast_to_common_type``, ``require_supported_dtype``, ``fill_out``,
``asarray_1d``), plus the one place where numpy and Python inputs
become tensors on a device.

Two promotion rules meet here, as in the JAX package.  Between two
sparse operands it applies numpy's ``result_type``
(``find_common_type``: int32 with float32 gives float64).  Between a
matrix's values and a dense operand or a scalar it applies ``jnp``'s
own rules, which ``result_type`` repeats: dense operands promote as
``torch.promote_types`` does (int32 with float32 gives float32), and a
Python scalar is weakly typed: it keeps the array's dtype unless its
kind is higher, and then takes the 64-bit default of its kind (the
JAX package runs with x64 on).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .runtime import resolve_device
from .types import SUPPORTED_DATATYPES, to_numpy_dtype, to_torch_dtype


def is_sparse_matrix(o: Any) -> bool:
    from .base import CsrDelegateMixin

    return isinstance(o, CsrDelegateMixin)


def _dtype_of(arg) -> torch.dtype:
    if isinstance(arg, torch.dtype):
        return arg
    if is_sparse_matrix(arg) or isinstance(arg, torch.Tensor):
        return arg.dtype
    if np.isscalar(arg):
        return to_torch_dtype(np.result_type(arg))
    return to_torch_dtype(np.asarray(arg).dtype)


def find_common_type(*args) -> torch.dtype:
    """numpy's ``result_type`` over torch dtypes, sparse matrices,
    tensors, arrays and scalars (reference ``utils.py:32-48``); bf16
    follows PyTorch's promotion, as ``jnp`` does."""
    dtypes = [_dtype_of(a) for a in args]
    if any(d == torch.bfloat16 for d in dtypes):
        out = dtypes[0]
        for d in dtypes[1:]:
            out = torch.promote_types(out, d)
        return out
    return to_torch_dtype(np.result_type(*[to_numpy_dtype(d)
                                           for d in dtypes]))


def cast_to_common_type(*args) -> Tuple[Any, ...]:
    """Cast every argument to the common dtype (reference
    ``utils.py:51-62``): sparse matrices by ``astype`` (structure
    shared, no copy when the dtype already agrees), tensors by ``.to``;
    anything else becomes a tensor on the device of the first sparse
    argument."""
    common = find_common_type(*args)
    device = next((a.device for a in args if is_sparse_matrix(a)), None)
    out = []
    for arg in args:
        if is_sparse_matrix(arg):
            out.append(arg.astype(common, copy=False))
        elif isinstance(arg, torch.Tensor):
            out.append(arg.to(common))
        else:
            out.append(as_tensor(arg, device_of(device), dtype=common))
    return tuple(out)


def _kind(dtype: torch.dtype) -> int:
    if dtype == torch.bool:
        return 0
    if dtype.is_complex:
        return 3
    if dtype.is_floating_point:
        return 2
    return 1


_WEAK_DEFAULT = {1: torch.int64, 2: torch.float64, 3: torch.complex128}


def _weak_scalar_kind(other):
    """Kind of a Python scalar (weakly typed in ``jnp``), else None."""
    if isinstance(other, bool):
        return 0
    if isinstance(other, int):
        return 1
    if isinstance(other, float):
        return 2
    if isinstance(other, complex):
        return 3
    return None


def result_type(dtype: torch.dtype, other) -> torch.dtype:
    """``jnp``'s result dtype of an array of ``dtype`` with ``other``: a
    torch dtype, a tensor, an array, a numpy scalar (strong: promoted as
    ``torch.promote_types``), or a Python scalar (weak)."""
    kind = _weak_scalar_kind(other)
    if kind is None:
        if isinstance(other, torch.dtype):
            return torch.promote_types(dtype, other)
        if isinstance(other, torch.Tensor):
            return torch.promote_types(dtype, other.dtype)
        return torch.promote_types(
            dtype, to_torch_dtype(np.asarray(other).dtype))
    own = _kind(dtype)
    if kind <= own:
        return dtype
    if kind == 3 and own == 2:
        return torch.complex128 if dtype == torch.float64 \
            else torch.complex64
    return _WEAK_DEFAULT[kind]


def to_inexact(dtype: torch.dtype) -> torch.dtype:
    """``jnp``'s inexact type of a dtype: bool and integers up to 32
    bits become float32, 64-bit integers float64, the rest stay."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype in (torch.int64,) else torch.float32


def true_divide_type(dtype: torch.dtype, other) -> torch.dtype:
    """``jnp.true_divide``'s result dtype of ``dtype`` by ``other``."""
    return to_inexact(result_type(dtype, other))


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


def asarray_1d(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A 1-D tensor on ``device`` from a vector or an (n, 1) column
    (reference ``utils.py:100-106``)."""
    arr = as_tensor(x, device, dtype=dtype)
    if arr.dim() == 2 and arr.shape[1] == 1:
        arr = arr.reshape(-1)
    if arr.dim() != 1:
        raise ValueError(f"expected 1-D array, got shape {tuple(arr.shape)}")
    return arr


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor (bf16 widens to float32).  A copy on
    the CPU too, so that writing into the result (scipy's in-place
    ``sum_duplicates`` on a ``toscipy()``) cannot reach the tensor."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def to_host(x) -> np.ndarray:
    """A numpy array of a tensor (``to_numpy``) or of anything
    ``np.asarray`` takes."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x)


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
        # order="C" keeps a 0-d input 0-d (np.ascontiguousarray makes it
        # 1-d).
        arr = np.asarray(x, order="C")
        if not arr.flags.writeable:     # e.g. a view of a JAX array
            arr = arr.copy()
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(
                arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        x = t
    if dtype is not None:
        dtype = to_torch_dtype(dtype)
    return x.to(device=device, dtype=dtype)
