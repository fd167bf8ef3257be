# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""CSR SpMV through the hand-written CUDA kernel ``csrc/csr_spmv.cu``.

``y[r] = Σ_{offsets[r] <= j < offsets[r+1]} data[j] · x[cols[j]]`` over a
CSR matrix's stored values, columns and row offsets.  The kernel
replaces no TPU kernel (the JAX package's ``csr_spmv_rowids`` is XLA's
gather and ``segment_sum``); it takes the place of the plain PyTorch ops
of ``ops/spmv.py::csr_spmv_rowids_plain`` on the card, which
``ops/spmv.py::csr_spmv_rowids`` routes to it.

It takes float32 and float64 values (x of the same type) with int32 or
int64 columns and int32 or int64 offsets.  The rows are scheduled by
length (``build_schedule``): a row of at most ``CHUNK`` stored entries
sums its products in slot order from +0.0; a longer (hub) row is cut
into chunks of ``CHUNK`` slots, each summed by one block in a fixed
tree, and the chunks' sums are added in chunk order from +0.0.  The
order depends only on the row's own slots.  ``csr_spmv_ordered`` is
that arithmetic in plain PyTorch, and the kernel agrees with it bit for
bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..obs import trace as _trace
from . import _build

KERNEL_DTYPES = (torch.float32, torch.float64)
INDEX_DTYPES = (torch.int32, torch.int64)
# The source's constants (``csrc/csr_spmv.cu``): threads of a block, the
# slot stretch a tile's rows start in, the longest row summed in slot
# order (and a hub row's chunk), the most rows in one tile.
BLOCK = 256
TILE = 1024
CHUNK = 1024
TILE_ROWS = 1024


def supported(data, indices, x) -> bool:
    """Whether the kernel takes these operands' types and ranks: 1-D f32
    or f64 values with int32 or int64 columns, and a 1-D x of the
    values' type on their device.  Every other operand (complex,
    low-precision, integer or mixed types, int16 columns) takes the
    plain ops."""
    return (data.dim() == 1 and indices.dim() == 1 and x.dim() == 1
            and data.dtype in KERNEL_DTYPES and x.dtype == data.dtype
            and indices.dtype in INDEX_DTYPES
            and data.device == x.device == indices.device)


def chunk_bound(nnz: int) -> int:
    """An upper bound on the hub chunks of ``nnz`` stored entries: a hub
    row of L > CHUNK entries has ceil(L / CHUNK) <= L / CHUNK + 1 chunks,
    and at most nnz / (CHUNK + 1) rows are hubs."""
    return nnz // CHUNK + nnz // (CHUNK + 1)


class Schedule:
    """The kernel's row schedule for one matrix's offsets, built on the
    device by ``build_schedule``.

    ``tile_rows`` (tiles + 1, int64): tile ``b`` holds rows
    ``tile_rows[b]`` to ``tile_rows[b + 1]``, which all start within one
    ``TILE``-slot stretch, at most ``TILE_ROWS`` of them.  ``chunk_row``
    and ``chunk_start`` (``chunk_bound(nnz)``, int64; empty under
    ``hubs=False``): the hub row and first slot of each chunk, hub rows in ascending order, each row's
    chunks in slot order, -1 past the last chunk.  ``counts`` (2, int64,
    on the device): the hub rows and the chunks."""

    __slots__ = ("tile_rows", "chunk_row", "chunk_start", "counts",
                 "_host_counts")

    def __init__(self, tile_rows, chunk_row, chunk_start, counts):
        self.tile_rows = tile_rows
        self.chunk_row = chunk_row
        self.chunk_start = chunk_start
        self.counts = counts
        self._host_counts = None

    @property
    def tiles(self) -> int:
        return int(self.tile_rows.shape[0]) - 1

    def host_counts(self) -> Tuple[int, int]:
        """``(hub rows, chunks)`` on the host: one device read, the first
        time only."""
        if self._host_counts is None:
            self._host_counts = tuple(int(v) for v in self.counts.tolist())
        return self._host_counts


def build_schedule(offsets, nnz: int, hubs: bool = True) -> Schedule:
    """The row schedule of a matrix with these ``rows + 1`` offsets and
    ``nnz`` slots, built with device ops and no host sync: each table is
    sized from ``rows`` and ``nnz`` alone.  ``hubs=False`` states that no
    row holds more than ``CHUNK`` entries (a matrix whose rows the plain
    ops sum one thread a row, ``csr_array._serial_rows``): the chunk
    tables are then empty and a product is the tile pass alone, one
    launch.  A row past ``CHUNK`` under such a schedule is left
    unsummed."""
    dev = offsets.device
    i64 = dict(dtype=torch.int64, device=dev)
    offs = offsets.to(torch.int64)
    rows = int(offs.shape[0]) - 1
    starts = offs[:-1]
    tiles = nnz // TILE + 1
    by_slot = torch.searchsorted(starts,
                                 torch.arange(tiles + 1, **i64) * TILE)
    by_count = torch.arange(0, rows, TILE_ROWS, **i64)
    tile_rows = torch.sort(torch.cat([by_slot, by_count])).values
    if not hubs:
        empty = torch.empty((0,), **i64)
        return Schedule(tile_rows, empty, empty, torch.zeros((2,), **i64))
    lengths = offs[1:] - starts
    per_row = torch.where(lengths > CHUNK, (lengths + CHUNK - 1) // CHUNK,
                          torch.zeros((), **i64))
    last = torch.cumsum(per_row, 0)
    k = torch.arange(chunk_bound(nnz), **i64)
    row = torch.searchsorted(last, k, right=True)
    live = row < rows
    rc = row.clamp(max=max(rows - 1, 0))
    if rows:
        first = last[rc] - per_row[rc]
        start = starts[rc] + (k - first) * CHUNK
    else:
        start = k
    none = torch.full((), -1, **i64)
    counts = torch.stack([(per_row > 0).sum(),
                          last[-1] if rows else torch.zeros((), **i64)])
    return Schedule(tile_rows, torch.where(live, row, none),
                    torch.where(live, start, none), counts)


def offsets_from_lengths(lengths) -> torch.Tensor:
    """``rows + 1`` int64 offsets from row lengths: one ``cumsum``."""
    offsets = torch.zeros((lengths.shape[0] + 1,), dtype=torch.int64,
                          device=lengths.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    return offsets


def _slot_order_sums(vals, lengths) -> torch.Tensor:
    """Sums of consecutive runs of ``lengths`` entries, each in slot
    order from +0.0: a 2-D ``segment_reduce``, one thread a run on the
    card, a loop on the CPU."""
    return torch.segment_reduce(vals[:, None], "sum", lengths=lengths,
                                unsafe=True)[:, 0]


def _chunk_sums(prods) -> torch.Tensor:
    """The kernel's sum of each (CHUNK,) row of ``prods`` (dead slots
    +0.0): thread t's slots t, t + BLOCK, ... in order from +0.0, then a
    shuffle-down tree within each warp and one over the warps."""
    lanes = prods.reshape(-1, CHUNK // BLOCK, BLOCK)
    acc = torch.zeros_like(lanes[:, 0])
    for q in range(CHUNK // BLOCK):
        acc = acc + lanes[:, q]
    v = acc.reshape(-1, BLOCK // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    w = v[..., 0]
    o = BLOCK // 64
    while o:
        w = w[:, :o] + w[:, o:2 * o]
        o //= 2
    return w[:, 0]


def csr_spmv_ordered(data, indices, offsets, x) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: each product rounded in
    the values' type; a row of at most ``CHUNK`` entries summed in slot
    order from +0.0; a hub row's chunks summed as ``_chunk_sums`` sums
    them and added in chunk order from +0.0."""
    offs = offsets.to(torch.int64)
    nnz = int(data.shape[0])
    lo, hi = int(offs[0]), int(offs[-1])
    prod = data * x[indices.to(torch.int64)]
    lengths = offs[1:] - offs[:-1]
    y = _slot_order_sums(prod[lo:hi], lengths)
    hub = lengths > CHUNK
    if not bool(hub.any()):
        return y
    sched = build_schedule(offs, nnz)
    live = sched.chunk_row >= 0
    row, start = sched.chunk_row[live], sched.chunk_start[live]
    end = torch.minimum(start + CHUNK, offs[row + 1])
    slot = start[:, None] + torch.arange(CHUNK, device=offs.device)
    taken = torch.where(slot < end[:, None], prod[slot.clamp(max=nnz - 1)],
                        torch.zeros((), dtype=prod.dtype,
                                    device=prod.device))
    partial = _chunk_sums(taken)
    y[hub] = _slot_order_sums(partial, (lengths[hub] + CHUNK - 1) // CHUNK)
    return y


def _lib() -> ctypes.CDLL:
    lib = _build.load("csr_spmv")
    fn = lib.csr_spmv
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(data, indices, offsets, x) -> None:
    """Raise on operands the kernel does not take."""
    for name, t in (("data", data), ("indices", indices),
                    ("offsets", offsets), ("x", x)):
        if t.dim() != 1:
            raise ValueError(f"csr_spmv: {name} must be 1-D, got "
                             f"{tuple(t.shape)}")
    if indices.shape[0] != data.shape[0]:
        raise ValueError(f"csr_spmv: indices hold {indices.shape[0]} "
                         f"entries, data {data.shape[0]}")
    if offsets.shape[0] < 1:
        raise ValueError("csr_spmv: offsets must hold rows + 1 entries")
    if data.dtype not in KERNEL_DTYPES or x.dtype != data.dtype:
        raise TypeError(f"csr_spmv: data {data.dtype} and x {x.dtype} "
                        f"must be one dtype of {KERNEL_DTYPES}")
    for name, t in (("indices", indices), ("offsets", offsets)):
        if t.dtype not in INDEX_DTYPES:
            raise TypeError(f"csr_spmv: {name} {t.dtype} must be one of "
                            f"{INDEX_DTYPES}")
    for t in (indices, offsets, x):
        if t.device != data.device:
            raise ValueError(f"csr_spmv: data on {data.device}, operand "
                             f"on {t.device}")
    if not all(t.is_contiguous() for t in (data, indices, offsets, x)):
        raise ValueError("csr_spmv: inputs must be contiguous")


def csr_spmv(data, indices, offsets, x,
             schedule: Optional[Schedule] = None) -> torch.Tensor:
    """y = A @ x over CSR arrays: the CUDA kernel for CUDA operands,
    ``csr_spmv_ordered`` for CPU ones.  ``schedule`` is
    ``build_schedule(offsets, nnz)``'s (a ``csr_array`` caches it), built
    here when absent.  While tracing is on, each call is a
    ``kernel.csr_spmv`` span with the matrix's ``hub_rows`` and
    ``chunks`` (read from the device once a schedule)."""
    _check(data, indices, offsets, x)
    if x.device.type == "cpu":
        return csr_spmv_ordered(data, indices, offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv: unsupported device {x.device}")
    rows = int(offsets.shape[0]) - 1
    y = torch.empty((rows,), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    nnz = int(data.shape[0])
    if schedule is None:
        schedule = build_schedule(offsets, nnz)
    bound = int(schedule.chunk_row.shape[0])
    partial = torch.empty((bound,), dtype=x.dtype, device=x.device)
    with _trace.span("kernel.csr_spmv") as sp:
        if sp is not None:
            hub_rows, chunks = schedule.host_counts()
            sp.set(hub_rows=hub_rows, chunks=chunks)
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.csr_spmv(
                data.data_ptr(), indices.data_ptr(), offsets.data_ptr(),
                x.data_ptr(), y.data_ptr(), schedule.tile_rows.data_ptr(),
                schedule.tiles, schedule.chunk_row.data_ptr(),
                schedule.chunk_start.data_ptr(), partial.data_ptr(), bound,
                data.element_size(), indices.element_size(),
                offsets.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"csr_spmv: kernel launch failed with "
                           f"cudaError {err}")
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
