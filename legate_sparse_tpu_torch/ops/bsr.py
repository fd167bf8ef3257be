# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Block-sparse (BSR) SpMV and SpMM through the hand-written CUDA
kernels ``csrc/bsr_spmv.cu`` and ``csrc/bsr_spmm.cu``.

Counterpart of ``legate_sparse_tpu/ops/bsr.py``: ``bsr_pack``
(``:62-119``, the numpy algorithm), ``BsrStructure.matvec``
(``:264``) and ``.matmat`` (``:278``), the plain versions
``bsr_spmv_plain`` (the counterpart of ``bsr_spmv_xla``, ``:232``) and
``bsr_spmm_plain``, and the kernel wrappers ``bsr_spmv`` (the
counterpart of ``bsr_spmv_pallas``, ``:143``) and ``bsr_spmm``
(``bsr_spmm_pallas``, ``:198``).  X stays row-major ``(cols_pad, k)``:
the TPU's transposed, k-padded chunks ``(nbc, k_pad, 128)`` have no
counterpart here.

The present 128x128 blocks of the matrix are densified and stored
transposed, ``blkT[b, c, r] = A[R0 + r, C0 + c]``, sorted by
(block-row, block-col); every empty block-row gets one zero block.  On
top of the JAX package's pack format the structure keeps a block-row
pointer ``bptr`` (nbr + 1), computed at pack time from the sorted
``brow``: the kernel runs one CTA per block-row over its blocks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

B = 128  # block edge
# Most present blocks a structure may hold (the JAX package's cap).
MAX_BLOCKS = 1 << 16
# Widest dense X the SpMM path takes (the JAX package's cap, ``:194``).
SPMM_MAX_K = 512
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def bsr_pack(data, indices, indptr, shape, max_expand: float):
    """Host-side CSR → transposed-BSR pack, or None over budget.

    Returns ``(blkT, brow, bcol, nbr, nbc)``: ``blkT`` (nb, B, B) f32
    with ``blkT[b, c, r]``, ``brow``/``bcol`` (nb,) int32 sorted by
    (brow, bcol), ``nbr``/``nbc`` the block-grid shape.  The budget
    (``nb <= MAX_BLOCKS`` and ``nb * B*B <= max_expand * nnz``) is
    checked before anything is densified."""
    rows, cols = shape
    data = np.asarray(data)
    indices = np.asarray(indices)
    indptr = np.asarray(indptr)
    nnz = data.shape[0]
    if nnz == 0 or rows == 0 or cols == 0 or max_expand <= 0:
        return None
    nbr = -(-rows // B)
    nbc = -(-cols // B)
    r = np.repeat(np.arange(rows, dtype=np.int64),
                  np.diff(indptr).astype(np.int64))
    c = indices.astype(np.int64)
    key = (r >> 7) * nbc + (c >> 7)
    uniq, inv = np.unique(key, return_inverse=True)
    # One zero block per empty block-row so y is fully written.
    missing = np.setdiff1d(np.arange(nbr, dtype=np.int64), uniq // nbc)
    nb = uniq.shape[0] + missing.shape[0]
    if nb > MAX_BLOCKS or nb * B * B > max_expand * nnz:
        return None
    all_keys = np.concatenate([uniq, missing * nbc])
    order = np.argsort(all_keys, kind="stable")
    all_keys = all_keys[order]
    pos_of_uniq = np.empty(nb, dtype=np.int64)
    pos_of_uniq[order] = np.arange(nb)
    bid = pos_of_uniq[inv.reshape(-1)]
    blkT = np.zeros((nb, B, B), dtype=np.float32)
    flat = bid * (B * B) + (c & (B - 1)) * B + (r & (B - 1))
    np.add.at(blkT.reshape(-1), flat, data.astype(np.float32))
    brow = (all_keys // nbc).astype(np.int32)
    bcol = (all_keys % nbc).astype(np.int32)
    return blkT, brow, bcol, nbr, nbc


def block_row_ptr(brow: np.ndarray, nbr: int) -> np.ndarray:
    """(nbr + 1,) int64 offsets of each block-row's blocks in ``brow``
    order (``brow`` sorted)."""
    return np.searchsorted(np.asarray(brow),
                           np.arange(nbr + 1)).astype(np.int64)


def bsr_spmv_plain(blkT, brow, bcol, x2d, nbr: int) -> torch.Tensor:
    """(nbr, B) f32 ``y2d = A @ x`` in plain PyTorch: gather the x chunk
    of each block, one batched matvec in f32, sum per block-row."""
    xg = x2d[bcol.long()].float()                          # (nb, B)
    prod = torch.einsum("bc,bcr->br", xg, blkT.float())    # (nb, B)
    y = torch.zeros((nbr, B), dtype=torch.float32, device=x2d.device)
    return y.index_add_(0, brow.long(), prod)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_spmv")
    for fn in (lib.bsr_spmv_f32, lib.bsr_spmv_bf16):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(blkT, brow, bcol, bptr, x2d, nbr: int,
           name: str = "bsr_spmv") -> None:
    """Raise on a structure or an x2d (one column of X for SpMM) the
    kernel does not take."""
    nb = blkT.shape[0]
    if blkT.dtype not in KERNEL_DTYPES or x2d.dtype != blkT.dtype:
        raise TypeError(f"{name}: blocks {blkT.dtype} and x {x2d.dtype} "
                        f"must be one dtype of {KERNEL_DTYPES}")
    if blkT.dim() != 3 or tuple(blkT.shape[1:]) != (B, B):
        raise ValueError(f"{name}: blkT must be (nb, {B}, {B}), got "
                         f"{tuple(blkT.shape)}")
    if x2d.dim() != 2 or x2d.shape[1] != B:
        raise ValueError(f"{name}: x2d must be (nbc, {B}), got "
                         f"{tuple(x2d.shape)}")
    if (brow.dtype != torch.int32 or bcol.dtype != torch.int32
            or bptr.dtype != torch.int64):
        raise TypeError(f"{name}: brow/bcol must be int32, bptr int64")
    if (tuple(brow.shape) != (nb,) or tuple(bcol.shape) != (nb,)
            or tuple(bptr.shape) != (nbr + 1,)):
        raise ValueError(f"{name}: brow/bcol must be (nb,), bptr "
                         "(nbr + 1,)")
    for t in (blkT, brow, bcol, bptr):
        if t.device != x2d.device:
            raise ValueError(f"{name}: structure on {t.device}, x on "
                             f"{x2d.device}")


def bsr_spmv(blkT, brow, bcol, bptr, x2d, nbr: int) -> torch.Tensor:
    """(nbr, B) f32 ``y2d = A @ x`` over the present blocks: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(blkT, brow, bcol, bptr, x2d, nbr)
    if x2d.device.type == "cpu":
        return bsr_spmv_plain(blkT, brow, bcol, x2d, nbr)
    if x2d.device.type != "cuda":
        raise ValueError(f"bsr_spmv: unsupported device {x2d.device}")
    if not all(t.is_contiguous() for t in (blkT, bcol, bptr, x2d)):
        raise ValueError("bsr_spmv: inputs must be contiguous")
    if nbr > 0x7FFFFFFF:
        raise ValueError(f"bsr_spmv: {nbr} block-rows exceed the grid")
    lib = _lib()
    fn = lib.bsr_spmv_f32 if blkT.dtype == torch.float32 else lib.bsr_spmv_bf16
    y2d = torch.empty((nbr, B), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(blkT.data_ptr(), bcol.data_ptr(), bptr.data_ptr(),
                 x2d.data_ptr(), y2d.data_ptr(), nbr, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmv: kernel launch failed with "
                           f"cudaError {err}")
    bsr_spmv.launches += 1
    return y2d


bsr_spmv.launches = 0


def bsr_spmm_plain(blkT, brow, bcol, X, nbr: int) -> torch.Tensor:
    """(nbr * B, k) f32 ``Y = A @ X`` in plain PyTorch, for X (nbc * B,
    k): gather the X chunk of each block, one batched product in f32,
    sum per block-row."""
    k = X.shape[1]
    xg = X.reshape(-1, B, k)[bcol.long()].float()              # (nb, B, k)
    prod = torch.einsum("bck,bcr->brk", xg, blkT.float())      # (nb, B, k)
    Y = torch.zeros((nbr, B, k), dtype=torch.float32, device=X.device)
    return Y.index_add_(0, brow.long(), prod).reshape(nbr * B, k)


def _spmm_lib() -> ctypes.CDLL:
    lib = _build.load("bsr_spmm")
    for fn in (lib.bsr_spmm_f32, lib.bsr_spmm_bf16):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64,
                                                   ctypes.c_int64,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def bsr_spmm(blkT, brow, bcol, bptr, X, nbr: int) -> torch.Tensor:
    """(nbr * B, k) f32 ``Y = A @ X`` over the present blocks, for X
    (nbc * B, k) row-major: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if X.dim() != 2 or X.shape[0] % B:
        raise ValueError(f"bsr_spmm: X must be (nbc * {B}, k), got "
                         f"{tuple(X.shape)}")
    k = X.shape[1]
    if not 1 <= k <= SPMM_MAX_K:
        raise ValueError(f"bsr_spmm: k = {k}; the kernel takes 1 to "
                         f"{SPMM_MAX_K}")
    _check(blkT, brow, bcol, bptr, X.reshape(-1, B, k)[:, :, 0], nbr,
           "bsr_spmm")
    if X.device.type == "cpu":
        return bsr_spmm_plain(blkT, brow, bcol, X, nbr)
    if X.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {X.device}")
    if not all(t.is_contiguous() for t in (blkT, bcol, bptr, X)):
        raise ValueError("bsr_spmm: inputs must be contiguous")
    if nbr > 0x7FFFFFFF:
        raise ValueError(f"bsr_spmm: {nbr} block-rows exceed the grid")
    lib = _spmm_lib()
    fn = lib.bsr_spmm_f32 if blkT.dtype == torch.float32 else lib.bsr_spmm_bf16
    Y = torch.empty((nbr * B, k), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(blkT.data_ptr(), bcol.data_ptr(), bptr.data_ptr(),
                 X.data_ptr(), Y.data_ptr(), nbr, k, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm: kernel launch failed with "
                           f"cudaError {err}")
    bsr_spmm.launches += 1
    return Y


bsr_spmm.launches = 0


class BsrStructure:
    """Device-resident BSR pack of one matrix, cached on ``csr_array``.

    ``dtype`` is the matrix dtype: f32 blocks for f32 matrices, bf16
    blocks for bf16 (half the bytes), f32 accumulation either way, and
    the result in the matrix dtype."""

    def __init__(self, blkT, brow, bcol, nbr, nbc, rows, cols,
                 dtype=torch.float32, device="cpu"):
        self.dtype = dtype
        self.nbr = int(nbr)
        self.nbc = int(nbc)
        self.rows = int(rows)
        self.cols = int(cols)
        bptr = block_row_ptr(brow, self.nbr)
        self.blkT = torch.from_numpy(blkT).to(device=device, dtype=dtype)
        self.brow = torch.from_numpy(np.asarray(brow)).to(device)
        self.bcol = torch.from_numpy(np.asarray(bcol)).to(device)
        self.bptr = torch.from_numpy(bptr).to(device)
        self.nblocks = int(self.blkT.shape[0])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(self.dtype).reshape(-1)
        pad = self.nbc * B - self.cols
        if pad:
            xf = torch.cat([xf, torch.zeros((pad,), dtype=self.dtype,
                                            device=xf.device)])
        y2d = bsr_spmv(self.blkT, self.brow, self.bcol, self.bptr,
                       xf.reshape(self.nbc, B), self.nbr)
        return y2d.reshape(-1)[: self.rows].to(self.dtype)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for dense (cols, k) X, k <= ``SPMM_MAX_K``."""
        k = X.shape[1]
        if k > SPMM_MAX_K:
            raise ValueError(f"BSR SpMM supports k <= {SPMM_MAX_K}, got {k}")
        Xf = X.to(self.dtype)
        pad = self.nbc * B - self.cols
        if pad:
            Xf = torch.cat([Xf, torch.zeros((pad, k), dtype=self.dtype,
                                            device=Xf.device)])
        Y = bsr_spmm(self.blkT, self.brow, self.bcol, self.bptr,
                     Xf.contiguous(), self.nbr)
        return Y[: self.rows].to(self.dtype)
