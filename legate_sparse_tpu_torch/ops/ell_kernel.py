# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""ELL SpMV through the hand-written CUDA kernel ``csrc/ell_spmv.cu``.

``y[r] = Σ_{s < counts[r]} data[r, s] · x[cols[r, s]]`` over the pack
``ops/spmv.py::ell_pack`` builds: (rows, W) values and columns, row-major,
and the (rows,) int32 counts.  The kernel replaces no TPU kernel (the JAX
package's ``ell_spmv`` is XLA ops); it takes the place of the plain
PyTorch ops of ``ops/spmv.py::ell_spmv_plain`` on the card, which
``ops/spmv.py::ell_spmv`` routes to it.

It takes float32 and float64 values (x of the same type) with int32 or
int64 columns, at widths W of 1 to ``MAX_TILE_W``.  Each product is
rounded on its own and the products are added in slot order from +0.0;
a slot at or past the row's count adds nothing and reads no x.
``ell_spmv_ordered`` is that arithmetic in plain PyTorch, and the kernel
agrees with it bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import trace as _trace
from . import _build

KERNEL_DTYPES = (torch.float32, torch.float64)
INDEX_DTYPES = (torch.int32, torch.int64)
# The widest pack the kernel is compiled for (``csrc/ell_spmv.cu``'s
# MAX_TILE_W): one thread a row, its slots staged in shared memory.  A
# wider pack takes the plain ops (``ops/spmv.py::ell_spmv``).
MAX_TILE_W = 16


def supported(ell_data, ell_cols, ell_counts, x) -> bool:
    """Whether the kernel takes these operands' types, ranks and width:
    a 2-D pack of 1 to ``MAX_TILE_W`` slots a row, f32 or f64 values with
    int32 or int64 columns, int32 counts, and a 1-D x of the values'
    type.  Every other operand (complex, low-precision, integer or mixed
    types, a wider or empty pack) takes the plain ops."""
    return (ell_data.dim() == 2 and x.dim() == 1
            and 1 <= ell_data.shape[1] <= MAX_TILE_W
            and ell_data.dtype in KERNEL_DTYPES and x.dtype == ell_data.dtype
            and ell_cols.dtype in INDEX_DTYPES
            and ell_counts.dtype == torch.int32)


def ell_spmv_ordered(ell_data, ell_cols, ell_counts, x) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: slot by slot, the
    product rounded in the values' type, a slot at or past the row's
    count replaced by +0.0, added to a sum that starts at +0.0."""
    rows, W = ell_data.shape
    acc = torch.zeros((rows,), dtype=ell_data.dtype, device=x.device)
    zero = torch.zeros((), dtype=ell_data.dtype, device=x.device)
    for s in range(W):
        prod = ell_data[:, s] * x[ell_cols[:, s].to(torch.int64)]
        acc = acc + torch.where(s < ell_counts, prod, zero)
    return acc


def _lib() -> ctypes.CDLL:
    lib = _build.load("ell_spmv")
    fn = lib.ell_spmv
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int64] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(ell_data, ell_cols, ell_counts, x) -> None:
    """Raise on operands the kernel does not take."""
    if ell_data.dim() != 2:
        raise ValueError(f"ell_spmv: data must be (rows, W), got "
                         f"{tuple(ell_data.shape)}")
    rows, W = ell_data.shape
    if not 1 <= W <= MAX_TILE_W:
        raise ValueError(f"ell_spmv: the kernel takes 1 to {MAX_TILE_W} "
                         f"slots a row, the pack has {W}")
    if tuple(ell_cols.shape) != (rows, W):
        raise ValueError(f"ell_spmv: cols must have shape ({rows}, {W}), "
                         f"got {tuple(ell_cols.shape)}")
    if tuple(ell_counts.shape) != (rows,):
        raise ValueError(f"ell_spmv: counts must have shape ({rows},), "
                         f"got {tuple(ell_counts.shape)}")
    if x.dim() != 1:
        raise ValueError(f"ell_spmv: x must be 1-D, got {tuple(x.shape)}")
    if ell_data.dtype not in KERNEL_DTYPES or x.dtype != ell_data.dtype:
        raise TypeError(f"ell_spmv: data {ell_data.dtype} and x {x.dtype} "
                        f"must be one dtype of {KERNEL_DTYPES}")
    if ell_cols.dtype not in INDEX_DTYPES:
        raise TypeError(f"ell_spmv: cols {ell_cols.dtype} must be one of "
                        f"{INDEX_DTYPES}")
    if ell_counts.dtype != torch.int32:
        raise TypeError(f"ell_spmv: counts {ell_counts.dtype} must be "
                        f"torch.int32")
    for t in (ell_cols, ell_counts, x):
        if t.device != ell_data.device:
            raise ValueError(f"ell_spmv: pack on {ell_data.device}, "
                             f"operand on {t.device}")
    if not all(t.is_contiguous()
               for t in (ell_data, ell_cols, ell_counts, x)):
        raise ValueError("ell_spmv: inputs must be contiguous")


@_trace.traced("kernel.ell_spmv")
def ell_spmv(ell_data, ell_cols, ell_counts, x) -> torch.Tensor:
    """y = A @ x over an ELL pack: the CUDA kernel for CUDA operands,
    ``ell_spmv_ordered`` for CPU ones."""
    _check(ell_data, ell_cols, ell_counts, x)
    if x.device.type == "cpu":
        return ell_spmv_ordered(ell_data, ell_cols, ell_counts, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {x.device}")
    rows, W = ell_data.shape
    y = torch.empty((rows,), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ell_spmv(ell_data.data_ptr(), ell_cols.data_ptr(),
                           ell_counts.data_ptr(), x.data_ptr(), y.data_ptr(),
                           rows, W, ell_data.element_size(),
                           ell_cols.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed with "
                           f"cudaError {err}")
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0
