# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Banded SpMV through the hand-written CUDA kernel ``csrc/dia_spmv.cu``.

Counterpart of the SpMV part of ``legate_sparse_tpu/ops/pallas_dia.py``:
``row_align`` (``:151``), ``PackedBand``/``pack_band`` (``:822-880``),
``pallas_dia_spmv`` (``:312``) and its gate ``dia_spmv_maybe_pallas``
(``:785``).

What carries over is the semantics: the row-aligned layout
``rdata[d, i] = A[i, i + off_d]`` (0 outside the matrix), x zeroed
before the multiply where ``i + off_d`` leaves ``[0, cols)`` or the
band has a hole (int8 mask), the product taken in the storage type and
summed in f32 in offset order, y in the matrix dtype.  The TPU's tile
padding, (…, 128) blocking, neighbour-tile views of x and lane/sublane
rolls do not: here the layout is a plain ``(nd, rows)`` tensor.

The gate (``supported``) takes f32 and bf16 bands of 1 to
``settings.dia_max_diags`` (at most 128) diagonals, with no limit on
the band's reach: the JAX package's reach limit (2^17, the largest
VMEM tile) was the TPU's.  So a band with ``|offset| > 2^17`` takes
``"dia-kernel"`` here where the JAX package takes ``"dia-xla"``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..settings import settings
from . import _build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Size of the offsets array in the kernel's parameter block.
MAX_DIAGS = 128


def supported(offsets: Tuple[int, ...], dtype: torch.dtype) -> bool:
    nd = len(offsets)
    return (dtype in KERNEL_DTYPES
            and 1 <= nd <= min(settings.dia_max_diags, MAX_DIAGS))


def row_align(dia_data: torch.Tensor, offsets: Tuple[int, ...],
              shape: Tuple[int, int], mask: Optional[torch.Tensor] = None):
    """Repack scipy-layout DIA storage (``dia_data[d, j] = A[j - off_d,
    j]``) into the kernel's row-aligned ``(nd, rows)`` layout.

    Returns ``(rdata, rmask)``: ``rdata[d, i] = dia_data[d, i + off_d]``
    where ``0 <= i + off_d < min(cols, width)``, else 0; ``rmask`` is the
    same slots of ``mask`` as int8, or None without a mask."""
    rows, cols = shape
    nd, width = dia_data.shape
    lim = min(cols, width)
    dev = dia_data.device
    rdata = torch.zeros((nd, rows), dtype=dia_data.dtype, device=dev)
    rmask = (torch.zeros((nd, rows), dtype=torch.int8, device=dev)
             if mask is not None else None)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(rows, lim - off)
        if hi <= lo:
            continue
        rdata[d, lo:hi] = dia_data[d, lo + off:hi + off]
        if mask is not None:
            rmask[d, lo:hi] = mask[d, lo + off:hi + off].to(torch.int8)
    return rdata, rmask


class PackedBand:
    """Row-aligned band pack, built once per matrix structure."""

    __slots__ = ("rdata", "rmask", "offsets", "shape")

    def __init__(self, rdata, rmask, offsets, shape):
        self.rdata = rdata
        self.rmask = rmask
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(int(s) for s in shape)


def pack_band(dia_data, offsets: Tuple[int, ...], shape: Tuple[int, int],
              mask=None) -> Optional[PackedBand]:
    """The kernel's pack of a scipy-layout band, or None when the kernel
    does not take this band (then the caller runs ``dia_ops``)."""
    if not supported(offsets, dia_data.dtype):
        return None
    rdata, rmask = row_align(dia_data, offsets, shape, mask=mask)
    return PackedBand(rdata, rmask, offsets, shape)


def dia_spmv_plain(rdata, rmask, x, offsets: Tuple[int, ...],
                   shape: Tuple[int, int]) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per diagonal, shift x,
    zero it outside ``[0, cols)`` and at holes, multiply in the storage
    type, add in f32 in offset order."""
    rows, cols = shape
    acc = torch.zeros((rows,), dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        xs = torch.zeros((rows,), dtype=x.dtype, device=x.device)
        lo, hi = max(0, -off), min(rows, cols - off)
        if hi > lo:
            xs[lo:hi] = x[lo + off:hi + off]
        if rmask is not None:
            xs = torch.where(rmask[d] > 0, xs, zero)
        acc = acc + (rdata[d] * xs).float()
    return acc.to(rdata.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("dia_spmv")
    for fn in (lib.dia_spmv_f32, lib.dia_spmv_bf16):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(packed: PackedBand, x: torch.Tensor) -> None:
    rows, cols = packed.shape
    nd = len(packed.offsets)
    rdata, rmask = packed.rdata, packed.rmask
    if x.dim() != 1 or x.shape[0] != cols:
        raise ValueError(f"dia_spmv: x must have shape ({cols},), got "
                         f"{tuple(x.shape)}")
    if x.dtype != rdata.dtype or rdata.dtype not in KERNEL_DTYPES:
        raise TypeError(f"dia_spmv: band {rdata.dtype} and x {x.dtype} "
                        f"must be one dtype of {KERNEL_DTYPES}")
    if tuple(rdata.shape) != (nd, rows):
        raise ValueError(f"dia_spmv: rdata must have shape ({nd}, {rows}), "
                         f"got {tuple(rdata.shape)}")
    if rmask is not None and (rmask.dtype != torch.int8
                              or tuple(rmask.shape) != (nd, rows)):
        raise ValueError("dia_spmv: rmask must be int8 of rdata's shape")
    if not 1 <= nd <= MAX_DIAGS:
        raise ValueError(f"dia_spmv: {nd} diagonals; the kernel takes 1 "
                         f"to {MAX_DIAGS}")
    for t in (rdata, rmask):
        if t is not None and t.device != x.device:
            raise ValueError(f"dia_spmv: pack on {t.device}, x on "
                             f"{x.device}")


def dia_spmv(packed: PackedBand, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a ``PackedBand``: the CUDA kernel for a CUDA ``x``,
    the plain version for a CPU ``x``."""
    _check(packed, x)
    rows, cols = packed.shape
    if x.device.type == "cpu":
        return dia_spmv_plain(packed.rdata, packed.rmask, x,
                              packed.offsets, packed.shape)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: unsupported device {x.device}")
    if not (x.is_contiguous() and packed.rdata.is_contiguous()
            and (packed.rmask is None or packed.rmask.is_contiguous())):
        raise ValueError("dia_spmv: inputs must be contiguous")
    lib = _lib()
    fn = lib.dia_spmv_f32 if x.dtype == torch.float32 else lib.dia_spmv_bf16
    nd = len(packed.offsets)
    offs = (ctypes.c_int * nd)(*packed.offsets)
    y = torch.empty((rows,), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(packed.rdata.data_ptr(),
                 packed.rmask.data_ptr() if packed.rmask is not None
                 else None,
                 x.data_ptr(), y.data_ptr(), rows, cols, nd, offs, stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv: kernel launch failed with "
                           f"cudaError {err}")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0
