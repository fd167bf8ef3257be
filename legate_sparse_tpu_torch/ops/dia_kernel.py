# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Banded SpMV, SpMM and SpGEMM through the hand-written CUDA kernels
``csrc/dia_spmv.cu``, ``csrc/dia_spmm.cu`` and ``csrc/dia_spgemm.cu``.

Counterpart of ``legate_sparse_tpu/ops/pallas_dia.py``: ``row_align``
(``:151``), ``PackedBand``/``pack_band`` (``:822-880``),
``pallas_dia_spmv`` (``:312``) and its gate ``dia_spmv_maybe_pallas``
(``:785``); ``pallas_dia_spmm`` (``:417``) and its gate
``dia_spmm_maybe_pallas`` (``:499``, k <= ``SPMM_MAX_K``);
``pallas_dia_spgemm`` (``:609``) and its gate
``dia_spgemm_maybe_pallas`` (``:687``, f32 or bf16, one dtype).

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
``"dia-kernel"`` here where the JAX package takes ``"dia-xla"``.  The
SpMM and SpGEMM gates drop the VMEM-derived tile checks for the same
reason.

bf16 rule, all three kernels: each product is rounded to the storage
type, then added in f32 (``pallas_dia.py:304``, ``:404``, ``:592``
write ``(data * x).astype(acc_dtype)``: a bf16 product widened).  The
result is rounded once more, to the storage type.
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


def _check(packed: PackedBand, x: torch.Tensor,
           name: str = "dia_spmv") -> None:
    """Raise on a pack or an x (one column of X for SpMM) the kernel
    does not take."""
    rows, cols = packed.shape
    nd = len(packed.offsets)
    rdata, rmask = packed.rdata, packed.rmask
    if x.dim() != 1 or x.shape[0] != cols:
        raise ValueError(f"{name}: x must have shape ({cols},), got "
                         f"{tuple(x.shape)}")
    if x.dtype != rdata.dtype or rdata.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: band {rdata.dtype} and x {x.dtype} "
                        f"must be one dtype of {KERNEL_DTYPES}")
    if tuple(rdata.shape) != (nd, rows):
        raise ValueError(f"{name}: rdata must have shape ({nd}, {rows}), "
                         f"got {tuple(rdata.shape)}")
    if rmask is not None and (rmask.dtype != torch.int8
                              or tuple(rmask.shape) != (nd, rows)):
        raise ValueError(f"{name}: rmask must be int8 of rdata's shape")
    if not 1 <= nd <= MAX_DIAGS:
        raise ValueError(f"{name}: {nd} diagonals; the kernel takes 1 "
                         f"to {MAX_DIAGS}")
    for t in (rdata, rmask):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: pack on {t.device}, x on "
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


# ---------------- SpMM: Y = A @ X over a PackedBand ----------------

# Widest dense X the SpMM kernel takes (the JAX package's cap,
# ``pallas_dia.py:412``); wider X takes the plain ``dia_ops`` route.
SPMM_MAX_K = 1024


def spmm_supported(packed: Optional[PackedBand], X: torch.Tensor) -> bool:
    """The gate of ``dia_spmm_maybe_pallas``: a kernel pack, 1 <= k <=
    ``SPMM_MAX_K`` and X in the band's dtype."""
    return (packed is not None and X.dim() == 2
            and 0 < X.shape[1] <= SPMM_MAX_K
            and X.dtype == packed.rdata.dtype)


def dia_spmm_plain(rdata, rmask, X, offsets: Tuple[int, ...],
                   shape: Tuple[int, int]) -> torch.Tensor:
    """The SpMM kernel's arithmetic in plain PyTorch: per diagonal,
    shift the rows of X, zero them outside ``[0, cols)`` and at holes,
    multiply in the storage type, add in f32 in offset order."""
    rows, cols = shape
    k = X.shape[1]
    acc = torch.zeros((rows, k), dtype=torch.float32, device=X.device)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    for d, off in enumerate(offsets):
        xs = torch.zeros((rows, k), dtype=X.dtype, device=X.device)
        lo, hi = max(0, -off), min(rows, cols - off)
        if hi > lo:
            xs[lo:hi] = X[lo + off:hi + off]
        if rmask is not None:
            xs = torch.where(rmask[d][:, None] > 0, xs, zero)
        acc = acc + (rdata[d][:, None] * xs).float()
    return acc.to(rdata.dtype)


def _spmm_lib() -> ctypes.CDLL:
    lib = _build.load("dia_spmm")
    for fn in (lib.dia_spmm_f32, lib.dia_spmm_bf16):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def dia_spmm(packed: PackedBand, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X (rows, k) over a ``PackedBand``: the CUDA kernel for a
    CUDA ``X``, the plain version for a CPU ``X``."""
    rows, cols = packed.shape
    if X.dim() != 2 or X.shape[0] != cols:
        raise ValueError(f"dia_spmm: X must have shape ({cols}, k), got "
                         f"{tuple(X.shape)}")
    k = X.shape[1]
    if not 1 <= k <= SPMM_MAX_K:
        raise ValueError(f"dia_spmm: k = {k}; the kernel takes 1 to "
                         f"{SPMM_MAX_K}")
    _check(packed, X[:, 0], "dia_spmm")
    if X.device.type == "cpu":
        return dia_spmm_plain(packed.rdata, packed.rmask, X, packed.offsets,
                              packed.shape)
    if X.device.type != "cuda":
        raise ValueError(f"dia_spmm: unsupported device {X.device}")
    if not (X.is_contiguous() and packed.rdata.is_contiguous()
            and (packed.rmask is None or packed.rmask.is_contiguous())):
        raise ValueError("dia_spmm: inputs must be contiguous")
    lib = _spmm_lib()
    fn = lib.dia_spmm_f32 if X.dtype == torch.float32 else lib.dia_spmm_bf16
    nd = len(packed.offsets)
    offs = (ctypes.c_int * nd)(*packed.offsets)
    Y = torch.empty((rows, k), dtype=X.dtype, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(packed.rdata.data_ptr(),
                 packed.rmask.data_ptr() if packed.rmask is not None
                 else None,
                 X.data_ptr(), Y.data_ptr(), rows, cols, k, nd, offs, stream)
    if err != 0:
        raise RuntimeError(f"dia_spmm: kernel launch failed with "
                           f"cudaError {err}")
    dia_spmm.launches += 1
    return Y


dia_spmm.launches = 0


# ---------------- SpGEMM: C_dia = A_dia @ B_dia ----------------

def spgemm_supported(a_data: torch.Tensor, b_data: torch.Tensor) -> bool:
    """The gate of ``dia_spgemm_maybe_pallas``: f32 or bf16, both
    operands of one dtype (the fallback promotes a mixed pair, the
    kernel would emit B's dtype: the result dtype must not depend on
    the route)."""
    return a_data.dtype == b_data.dtype and a_data.dtype in KERNEL_DTYPES


def spgemm_pairs(offs_a: Tuple[int, ...], offs_b: Tuple[int, ...],
                 offs_c: Tuple[int, ...], shape_a: Tuple[int, int],
                 shape_b: Tuple[int, int]):
    """Per output diagonal, the ``(a_i, b_i, ob, j_lo, j_hi)`` of every
    (oa, ob) pair with ``oa + ob == oc`` and a non-empty valid range
    ``[max(0, ob, oc), min(n, k + ob, m + oc))``, in ``offs_b`` order
    (the Pallas kernel's outer loop, ``pallas_dia.py:581``)."""
    m, k = shape_a
    n = shape_b[1]
    idx_a = {o: i for i, o in enumerate(offs_a)}
    out = []
    for oc in offs_c:
        pairs = []
        for b_i, ob in enumerate(offs_b):
            a_i = idx_a.get(oc - ob)
            if a_i is None:
                continue
            j_lo, j_hi = max(0, ob, oc), min(n, k + ob, m + oc)
            if j_hi > j_lo:
                pairs.append((a_i, b_i, ob, j_lo, j_hi))
        out.append(pairs)
    return out


def dia_spgemm_plain(a_data, b_data, offs_a: Tuple[int, ...],
                     offs_b: Tuple[int, ...], offs_c: Tuple[int, ...],
                     shape_a: Tuple[int, int],
                     shape_b: Tuple[int, int]) -> torch.Tensor:
    """The SpGEMM kernel's arithmetic in plain PyTorch: for each output
    diagonal, its pairs in ``offs_b`` order, the product in the storage
    type, the sum in ``promote_types(dtype, float32)`` (f32 for f32 and
    bf16, as the kernel); C (ndc, n) in the inputs' promoted dtype.
    Also the ``"dia-torch"`` route of ``csr.spgemm_csr_csr_csr``, for
    the dtypes the kernel declines (f64, complex)."""
    n = shape_b[1]
    dtype = torch.promote_types(a_data.dtype, b_data.dtype)
    a_data, b_data = a_data.to(dtype), b_data.to(dtype)
    C = torch.zeros((len(offs_c), n),
                    dtype=torch.promote_types(dtype, torch.float32),
                    device=b_data.device)
    for ci, pairs in enumerate(spgemm_pairs(offs_a, offs_b, offs_c, shape_a,
                                            shape_b)):
        for a_i, b_i, ob, j_lo, j_hi in pairs:
            C[ci, j_lo:j_hi] += (a_data[a_i, j_lo - ob:j_hi - ob]
                                 * b_data[b_i, j_lo:j_hi]).to(C.dtype)
    return C.to(dtype)


def _spgemm_lib() -> ctypes.CDLL:
    lib = _build.load("dia_spgemm")
    for fn in (lib.dia_spgemm_f32, lib.dia_spgemm_bf16):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
                ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
    return lib


def dia_spgemm(a_data, b_data, offs_a: Tuple[int, ...],
               offs_b: Tuple[int, ...], offs_c: Tuple[int, ...],
               shape_a: Tuple[int, int],
               shape_b: Tuple[int, int]) -> torch.Tensor:
    """C_dia (ndc, n) = A_dia @ B_dia over exact scipy-layout bands (A
    (nda, k), B (ndb, n)): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    m, k = shape_a
    kb, n = shape_b
    if kb != k:
        raise ValueError(f"dia_spgemm: shapes {shape_a} @ {shape_b}")
    if not spgemm_supported(a_data, b_data):
        raise TypeError(f"dia_spgemm: A {a_data.dtype} and B "
                        f"{b_data.dtype} must be one dtype of "
                        f"{KERNEL_DTYPES}")
    if (tuple(a_data.shape) != (len(offs_a), k)
            or tuple(b_data.shape) != (len(offs_b), n)):
        raise ValueError(f"dia_spgemm: bands must be ({len(offs_a)}, {k}) "
                         f"and ({len(offs_b)}, {n}), got "
                         f"{tuple(a_data.shape)} and {tuple(b_data.shape)}")
    if a_data.device != b_data.device:
        raise ValueError(f"dia_spgemm: A on {a_data.device}, B on "
                         f"{b_data.device}")
    dev = b_data.device
    if dev.type == "cpu":
        return dia_spgemm_plain(a_data, b_data, offs_a, offs_b, offs_c,
                                shape_a, shape_b)
    if dev.type != "cuda":
        raise ValueError(f"dia_spgemm: unsupported device {dev}")
    if not (a_data.is_contiguous() and b_data.is_contiguous()):
        raise ValueError("dia_spgemm: inputs must be contiguous")
    ndc = len(offs_c)
    if ndc > 65535:
        raise ValueError(f"dia_spgemm: {ndc} output diagonals exceed the "
                         f"grid")
    by_c = spgemm_pairs(offs_a, offs_b, offs_c, shape_a, shape_b)
    flat = [p for pairs in by_c for p in pairs]
    ptr = [0]
    for pairs in by_c:
        ptr.append(ptr[-1] + len(pairs))
    pairs_t = torch.tensor(flat if flat else [(0, 0, 0, 0, 0)],
                           dtype=torch.int64).to(dev)
    ptr_t = torch.tensor(ptr, dtype=torch.int64).to(dev)
    C = torch.empty((ndc, n), dtype=b_data.dtype, device=dev)
    lib = _spgemm_lib()
    fn = (lib.dia_spgemm_f32 if b_data.dtype == torch.float32
          else lib.dia_spgemm_bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a_data.data_ptr(), b_data.data_ptr(), C.data_ptr(), k, n,
                 ndc, pairs_t.data_ptr(), ptr_t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dia_spgemm: kernel launch failed with "
                           f"cudaError {err}")
    dia_spgemm.launches += 1
    return C


dia_spgemm.launches = 0
