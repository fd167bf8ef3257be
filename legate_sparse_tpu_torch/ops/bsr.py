# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Block-sparse (BSR) SpMV and SpMM through the hand-written CUDA
kernels ``csrc/bsr_spmv.cu`` and ``csrc/bsr_spmm.cu``.

Counterpart of ``legate_sparse_tpu/ops/bsr.py``: the structure
(``bsr_pack``, ``:62-119``), ``BsrStructure.matvec`` (``:264``) and
``.matmat`` (``:278``), the plain versions ``bsr_spmv_plain`` (the
counterpart of ``bsr_spmv_xla``, ``:232``) and ``bsr_spmm_plain``, and
the kernel wrappers ``bsr_spmv`` (``bsr_spmv_pallas``, ``:143``) and
``bsr_spmm`` (``bsr_spmm_pallas``, ``:198``).  X stays row-major
``(cols_pad, k)``: the TPU's transposed, k-padded chunks have no
counterpart here.

The functions are those of the Pallas kernels: ``A @ x`` and ``A @ X``
over the present 128x128 blocks, whose zero slots multiply x (a
non-finite x in a present block's column chunk reaches every row of
that block-row).  The storage is not theirs.  The TPU densifies the
present blocks because Mosaic cannot gather single elements; the card
can, so the structure keeps only the block list, built on the device
(``build_structure``): ``brow``/``bcol`` (int32, sorted by (block-row,
block-col), one zero block per empty block-row, equal to the JAX
``bsr_pack``'s) and the block-row pointer ``bptr`` (int64, nbr + 1),
beside references to the matrix's own ``data``/``indices``/``indptr``.
The kernels walk the stored nonzeros against x chunks staged in shared
memory.  Only the plain versions densify (``densify``, equal to the JAX
pack's ``blkT`` bit for bit), for the CPU tests and the comparison on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import trace as _trace
from . import _build
from .convert import row_ids_from_indptr, segment_sum

B = 128  # block edge
# Most present blocks a structure may hold (the JAX package's cap).
MAX_BLOCKS = 1 << 16
# Widest dense X the SpMM path takes (the JAX package's cap, ``:194``).
SPMM_MAX_K = 512
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Column index dtypes the kernels are instantiated for: int16 is
# compressed storage's (``csr_array.compress``).
INDEX_DTYPES = (torch.int16, torch.int32, torch.int64)


class BsrStructure:
    """The present-block list of one CSR matrix, cached on
    ``csr_array``; built by ``build_structure``.

    ``data``/``indices``/``indptr`` are the matrix's own tensors (no
    copy); ``brow``/``bcol``/``bptr`` are all the structure adds.
    ``dtype`` is the matrix dtype: f32 accumulation either way, the
    result in the matrix dtype."""

    def __init__(self, data, indices, indptr, brow, bcol, bptr, nbr, nbc,
                 rows, cols):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.brow = brow
        self.bcol = bcol
        self.bptr = bptr
        self.nbr = int(nbr)
        self.nbc = int(nbc)
        self.rows = int(rows)
        self.cols = int(cols)
        self.dtype = data.dtype
        self.nblocks = int(brow.shape[0])

    @property
    def extra_bytes(self) -> int:
        """Device bytes the structure adds to the matrix."""
        return sum(t.numel() * t.element_size()
                   for t in (self.brow, self.bcol, self.bptr))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(self.dtype).reshape(-1)
        pad = self.nbc * B - self.cols
        if pad:
            xf = torch.cat([xf, torch.zeros((pad,), dtype=self.dtype,
                                            device=xf.device)])
        xf = _aligned(xf.contiguous())
        y2d = bsr_spmv(self, xf.reshape(self.nbc, B))
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
        Y = bsr_spmm(self, _aligned(Xf.contiguous()))
        return Y[: self.rows].to(self.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its storage is not 16-byte aligned
    (the kernels stage x with 16-byte asynchronous copies)."""
    return t.clone() if t.data_ptr() % 16 else t


def build_structure(data, indices, indptr, row_ids, shape,
                    max_expand: float, probe=None):
    """The ``BsrStructure`` of a canonical CSR matrix, built from its
    device tensors (``row_ids``: its per-nonzero row ids), or None over
    budget.  ``probe``, a live span (``csr_array._get_bsr``'s), takes
    the blocks counted as ``blocks``.

    The budget is the JAX ``bsr_pack``'s: the present blocks plus one
    zero block per empty block-row number at most ``MAX_BLOCKS``, and
    their densified slots at most ``max_expand * nnz``.  It is checked
    before anything else is built.  Two host syncs: the sizes of the
    unique block keys and of the empty block-rows."""
    rows, cols = shape
    nnz = int(data.shape[0])
    if nnz == 0 or rows == 0 or cols == 0 or max_expand <= 0:
        return None
    dev = data.device
    nbr = -(-rows // B)
    nbc = -(-cols // B)
    key = (row_ids.to(torch.int64) >> 7) * nbc + (indices.to(torch.int64) >> 7)
    uniq = torch.unique(key, sorted=True)
    has = torch.zeros((nbr,), dtype=torch.bool, device=dev)
    has[uniq // nbc] = True
    missing = torch.nonzero(~has).reshape(-1)
    nb = int(uniq.shape[0]) + int(missing.shape[0])
    if probe is not None:
        probe.set(blocks=nb)
    if nb > MAX_BLOCKS or nb * B * B > max_expand * nnz:
        return None
    all_keys = torch.sort(torch.cat([uniq, missing * nbc])).values
    brow = torch.div(all_keys, nbc, rounding_mode="floor").to(torch.int32)
    bcol = (all_keys % nbc).to(torch.int32)
    bptr = torch.searchsorted(
        brow, torch.arange(nbr + 1, dtype=torch.int32, device=dev))
    return BsrStructure(data, indices, indptr, brow, bcol, bptr, nbr, nbc,
                        rows, cols)


def densify(st: BsrStructure) -> torch.Tensor:
    """(nb, B, B) f32 ``blkT[b, c, r] = A[R0 + r, C0 + c]`` of the
    present blocks: the JAX pack's ``blkT``."""
    row_ids = row_ids_from_indptr(st.indptr, st.data.shape[0])
    col = st.indices.to(torch.int64)
    key = (row_ids >> 7) * st.nbc + (col >> 7)
    all_keys = st.brow.to(torch.int64) * st.nbc + st.bcol.to(torch.int64)
    bid = torch.searchsorted(all_keys, key)
    flat = bid * (B * B) + (col & (B - 1)) * B + (row_ids & (B - 1))
    blkT = torch.zeros((st.nblocks * B * B,), dtype=torch.float32,
                       device=st.data.device)
    blkT.index_put_((flat,), st.data.float(), accumulate=True)
    return blkT.reshape(st.nblocks, B, B)


def bsr_spmv_plain(st: BsrStructure, x2d) -> torch.Tensor:
    """(nbr, B) f32 ``y2d = A @ x`` in plain PyTorch: densify the
    present blocks, gather the x chunk of each, one batched matvec in
    f32, sum per block-row.  The blocks are sorted by block-row, so the
    sum is a segment sum over ``bptr``'s runs, in one fixed order (an
    ``index_add_`` is an atomic add on CUDA, in no fixed order)."""
    xg = x2d[st.bcol.long()].float()                          # (nb, B)
    prod = torch.einsum("bc,bcr->br", xg, densify(st))        # (nb, B)
    return segment_sum(prod, st.bptr[1:] - st.bptr[:-1])


def bsr_spmm_plain(st: BsrStructure, X) -> torch.Tensor:
    """(nbr * B, k) f32 ``Y = A @ X`` in plain PyTorch, for X (nbc * B,
    k): densify, gather the X chunk of each block, one batched product
    in f32, a segment sum per block-row (as ``bsr_spmv_plain``)."""
    k = X.shape[1]
    xg = X.reshape(-1, B, k)[st.bcol.long()].float()              # (nb, B, k)
    prod = torch.einsum("bck,bcr->brk", xg, densify(st))          # (nb, B, k)
    return segment_sum(prod, st.bptr[1:] - st.bptr[:-1]).reshape(
        st.nbr * B, k)


def _check(st: BsrStructure, x2d, name: str) -> None:
    """Raise on a structure or an x2d (one column of X for SpMM) the
    kernel does not take."""
    if st.data.dtype not in KERNEL_DTYPES or x2d.dtype != st.data.dtype:
        raise TypeError(f"{name}: values {st.data.dtype} and x {x2d.dtype} "
                        f"must be one dtype of {KERNEL_DTYPES}")
    if x2d.dim() != 2 or tuple(x2d.shape) != (st.nbc, B):
        raise ValueError(f"{name}: x2d must be ({st.nbc}, {B}), got "
                         f"{tuple(x2d.shape)}")
    if (st.indices.dtype not in INDEX_DTYPES
            or st.indptr.dtype != torch.int64
            or st.brow.dtype != torch.int32 or st.bcol.dtype != torch.int32
            or st.bptr.dtype != torch.int64):
        raise TypeError(f"{name}: indices must be int16/int32/int64, "
                        "indptr and bptr int64, brow/bcol int32")
    if (tuple(st.indptr.shape) != (st.rows + 1,)
            or tuple(st.bcol.shape) != (st.nblocks,)
            or tuple(st.bptr.shape) != (st.nbr + 1,)):
        raise ValueError(f"{name}: indptr must be (rows + 1,), bcol "
                         "(nb,), bptr (nbr + 1,)")
    for t in (st.data, st.indices, st.indptr, st.brow, st.bcol, st.bptr):
        if t.device != x2d.device:
            raise ValueError(f"{name}: structure on {t.device}, x on "
                             f"{x2d.device}")


def _launch_args(st: BsrStructure, x, name: str):
    """The pointer arguments shared by both kernels, after the checks
    only a launch needs."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (st.data, st.indices, st.indptr,
                                           st.bcol, st.bptr, x)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    if st.nbr > 0x7FFFFFFF:
        raise ValueError(f"{name}: {st.nbr} block-rows exceed the grid")
    return (int(st.data.dtype == torch.bfloat16),
            st.indices.element_size(), st.data.data_ptr(),
            st.indices.data_ptr(), st.indptr.data_ptr(), st.bcol.data_ptr(),
            st.bptr.data_ptr(), x.data_ptr())


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        # (bf16, index bytes, data, indices, indptr, bcol, bptr, x, y,
        #  rows, nbr[, k], stream)
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int64] * (3 if name == "bsr_spmm" else 2)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@_trace.traced("kernel.bsr_spmv")
def bsr_spmv(st: BsrStructure, x2d) -> torch.Tensor:
    """(nbr, B) f32 ``y2d = A @ x`` over the present blocks, for x2d
    (nbc, B): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check(st, x2d, "bsr_spmv")
    if x2d.device.type == "cpu":
        return bsr_spmv_plain(st, x2d)
    args = _launch_args(st, x2d, "bsr_spmv")
    y2d = torch.empty((st.nbr, B), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("bsr_spmv").bsr_spmv(*args, y2d.data_ptr(), st.rows,
                                        st.nbr, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmv: kernel launch failed with "
                           f"cudaError {err}")
    bsr_spmv.launches += 1
    return y2d


bsr_spmv.launches = 0


@_trace.traced("kernel.bsr_spmm")
def bsr_spmm(st: BsrStructure, X) -> torch.Tensor:
    """(nbr * B, k) f32 ``Y = A @ X`` over the present blocks, for X
    (nbc * B, k) row-major: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if X.dim() != 2 or X.shape[0] != st.nbc * B:
        raise ValueError(f"bsr_spmm: X must be ({st.nbc * B}, k), got "
                         f"{tuple(X.shape)}")
    k = X.shape[1]
    if not 1 <= k <= SPMM_MAX_K:
        raise ValueError(f"bsr_spmm: k = {k}; the kernel takes 1 to "
                         f"{SPMM_MAX_K}")
    _check(st, X.reshape(-1, B, k)[:, :, 0], "bsr_spmm")
    if X.device.type == "cpu":
        return bsr_spmm_plain(st, X)
    args = _launch_args(st, X, "bsr_spmm")
    Y = torch.empty((st.nbr * B, k), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("bsr_spmm").bsr_spmm(*args, Y.data_ptr(), st.rows,
                                        st.nbr, k, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm: kernel launch failed with "
                           f"cudaError {err}")
    bsr_spmm.launches += 1
    return Y


bsr_spmm.launches = 0
