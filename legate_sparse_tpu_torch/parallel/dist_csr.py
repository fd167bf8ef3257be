# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Row-block distributed CSR, distributed SpMV/SpMM and the distributed
solvers, on ``torch.distributed``.

Counterpart of ``legate_sparse_tpu/parallel/dist_csr.py``: ``DistCSR``
(``:71-356``), ``attach_dia_prepack`` (``:358``), the precise gather
plan (``:404-455``), the per-shard DIA blocks (``:457``), the layout
routing (``:517-569``), ``_shard_csr_2d`` (``:571``), ``shard_csr``
(``:653``), ``shard_vector``/``shard_dense``, the fingerprints,
``dist_spmv`` (``:1506``, its dispatch ``_dist_spmv_impl``
``:1606-1711``), ``dist_spmm`` (``:1907``), ``attach_bsr_prepack``
(``:1984``), the comm volumes (``:1367-1413``), the solvers
``dist_gmres``/``dist_bicgstab``/``dist_minres`` (``:2237-2365``),
``dist_eigsh`` (``:2367``), ``dist_diagonal`` (``:2436``) and
``dist_cg`` (``:2530``).

The JAX package is one controller over a mesh: a ``DistCSR`` holds
global arrays with a leading shard axis, and each product is a
``shard_map`` body with explicit collectives.  Here every rank is a
process that calls the same functions with the same arguments (SPMD);
a ``DistCSR`` holds this rank's blocks only (no leading shard axis),
and the bodies are plain code on the local tensors with explicit
collectives on the mesh's process groups: ``ppermute`` is a
``batch_isend_irecv`` to the ring neighbours (a local copy where the
neighbour is the rank itself), the tiled ``all_gather`` is
``all_gather_single``, ``psum`` is ``all_reduce``, ``psum_scatter`` is
``reduce_scatter_tensor`` and ``all_to_all`` is ``all_to_all_single``.
A global sharded vector (``shard_vector``, ``shard_dense``, every
``dist_*`` result) is a ``DTensor``: ``Shard(0)`` over "rows" for the
1d-row layout, ``Shard(0)`` over the flat mesh of every rank for the 2-d
layouts (chunk k on rank k, the JAX package's row-major grid chunks),
with the global shape the JAX package returns.  The arithmetic runs on
``to_local()`` tensors, never through DTensor's op dispatch.

The per-shard kernels are the port's: the DIA route runs
``ops/dia_kernel.py::dia_spmv``/``dia_spmm`` (``csrc/dia_spmv.cu``,
``csrc/dia_spmm.cu``) on the halo-extended window with offsets shifted
by +halo (``dist_csr.py:1067``, ``:1892``), the BSR route runs
``ops/bsr.py::bsr_spmv`` (``csrc/bsr_spmv.cu``) on the rank's row block
against the all-gathered x (``:2082``).  The JAX package's
``pallas_dist_mode`` is a TPU knob with no counterpart: the kernel
route is taken wherever its gate admits it (on the card the kernel
launches; a CPU tensor takes its plain version).  Route labels:
``"dia-kernel"`` where the JAX package says ``"dia-pallas"``,
``"dia-torch"`` for ``"dia-xla"``.

Observability: ``op.shard_csr``, ``op.dist_spmv``, ``op.dist_spmm``,
``op.dist_cg`` per call; ``lat.dist_spmv.<bucket>``; the ``dist_spmv``
span (``path``, ``shards``, ``halo``, ``comm_bytes``, ``comm_calls``);
``comm.dist_spmv.*``/``comm.dist_spmm.*`` per call, and for the solvers
``comm.dist_<solver>.psum``: the all-reduces of inner products and
norms the solve ran (each SpMV records itself).

The semiring arm (``dist_spmv``/``dist_spmm`` with ``semiring=``,
``dist_csr.py:1415-1503``, ``:1808-1871``): any catalog entry but
plus-times (which takes the ordinary dispatch) runs the ELL or padded-CSR
blocks through ``ops/spmv.py``'s semiring products, never the DIA or BSR
route.  The 1-d realizations are plus-times' own; on the 2-d layouts the
partial rows are all-reduced along mesh columns by the semiring's add
(``ReduceOp.MIN``/``MAX``) where plus-times reduce-scatters a sum.
NCCL and gloo reduce no ``torch.bool``: an or-and frontier travels as
its ``uint8`` view and is or-ed as a ``MAX``.  Counters
``graph.dist_spmv.<name>``/``graph.dist_spmm.<name>``.

Resilience (``settings.resil``, ``dist_csr.py:1531-1605``, ``:2133-2235``):
``dist_spmv`` (both arms) is the ``dist.spmv`` fault/retry site, and with
``settings.resil_abft`` its plus-times product is checked against the
column checksum (``_dist_spmv_abft``: ``sum(y) = <w, x>``, one stacked
fetch).  The solvers' loop products (``matvec_fn``) bypass the site, as
the JAX package's traced loops do; ``dist_cg``'s first residual goes
through it.  ``dist_cg`` is the ``dist.cg`` site, and both ``dist_cg`` and
``dist_gmres`` run under the recovery ladder (``_solve_with_recovery``):
on a ``DeviceLost`` every rank builds the survivor mesh, the lost rank
leaves the solve raising ``DeviceLost``, and the survivors reshard from
the kept source, restore the last checkpoint and resume.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..obs import comm as _comm
from ..obs import context as _tctx
from ..obs import counters as _obs_counters
from ..obs import latency as _lat
from ..obs import trace as _trace
from ..ops import bsr as _bsr_ops
from ..ops import dia_kernel as _dia_kernel
from ..ops import spmv as _spmv_ops
from ..resilience import checkpoint as _rckpt
from ..resilience import faults as _rfaults
from ..resilience import guarded_call as _resil_guarded
from ..resilience.outcomes import ChecksumError, DeviceLost
from ..settings import settings as _settings
from ..utils import as_tensor, to_numpy
from .mesh import (
    COL_AXIS, LAYOUT_1D_COL, LAYOUT_1D_ROW, LAYOUT_2D_BLOCK, LAYOUT_AUTO,
    ROW_AXIS, _mesh, factor_grid, flat_mesh, job_cache, make_row_mesh,
    mesh_device, mesh_position, mesh_ranks, resolve_layout, row_sharding,
    survivor_mesh,
)

_LOWP = (torch.bfloat16, torch.float16)


@dataclass
class DistCSR:
    """This rank's blocks of a sharded sparse matrix.

    1d-row ELL (``ell=True``): ``data``/``cols`` (rps, W), ``counts``
    (rps,) per-row nnz; ``cols`` index the halo-extended x window when
    ``halo >= 0``, the precise plan's compact buffer when
    ``gather_idx`` is set, else global columns.  1d-row padded CSR:
    ``data``/``cols``/``row_ids`` (nnz_max,), ``counts`` a 0-d valid
    count.  2-d layouts (``grid`` set): this rank's block (i, j) as
    padded CSR with block-local columns.

    ``dia_data``/``dia_mask`` (nd, rps) are the banded blocks of the
    halo mode, ``dia_pack`` their kernel pack over the window
    (``attach_dia_prepack``), ``bsr`` the BSR structure of an
    all-gather row block (``attach_bsr_prepack``).

    ``nnz_cap`` is the largest padded-CSR block over the ranks where a
    rank's own block is smaller (every rank holds the same number; 0
    where each block is the shared size): the JAX package's padded
    width, which the comm formulas and ``dist_spgemm``'s plan key read.
    ``_src_csr`` is the ``csr_array`` ``shard_csr`` partitioned, which
    ``reshard`` repartitions."""

    data: Optional[torch.Tensor]
    cols: Optional[torch.Tensor]
    counts: Optional[torch.Tensor]
    row_ids: Optional[torch.Tensor]
    shape: Tuple[int, int]
    rows_per_shard: int
    halo: int           # -1: no halo window (all-gather realization)
    ell: bool
    mesh: object
    # Precise plan: (R_dst, C) local x indices this rank sends to each
    # destination, and (R_src, C) the global column of each compact
    # receive position.
    gather_idx: Optional[torch.Tensor] = None
    gather_globals: Optional[torch.Tensor] = None
    cols_per_shard: int = 0
    dia_data: Optional[torch.Tensor] = None
    dia_offsets: Optional[Tuple[int, ...]] = None
    dia_mask: Optional[torch.Tensor] = None
    dia_pack: Optional[_dia_kernel.PackedBand] = None
    bsr: Optional[_bsr_ops.BsrStructure] = None
    bsr_tried: bool = False
    nnz_hint: int = 0
    layout: str = LAYOUT_1D_ROW
    grid: Optional[Tuple[int, int]] = None
    nnz_cap: int = 0
    _src_csr: object = field(default=None, repr=False, compare=False)

    # ---- where this rank sits ----
    @property
    def num_shards(self) -> int:
        if self.grid is not None:
            return self.grid[0] * self.grid[1]
        return self.mesh.size(0)

    @property
    def shard(self) -> int:
        """This rank's row block (1d-row) or flat chunk (2-d): its
        position in the mesh."""
        if self.grid is not None:
            return mesh_position(self.mesh)
        return self.mesh.get_local_rank(ROW_AXIS)

    @property
    def rows_padded(self) -> int:
        if self.grid is not None:
            return self.grid[0] * self.rows_per_shard
        return self.num_shards * self.rows_per_shard

    @property
    def cols_padded(self) -> int:
        if self.grid is not None:
            return self.grid[1] * self.cols_per_shard
        return self.shape[1]

    @property
    def local_len(self) -> int:
        """Length of this rank's block of x and y."""
        if self.grid is not None:
            return self.rows_padded // self.num_shards
        return self.rows_per_shard

    @property
    def dtype(self) -> torch.dtype:
        blocks = self.data if self.data is not None else self.dia_data
        return blocks.dtype

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    @property
    def vector_group(self):
        """The group a vector's blocks are spread over: "rows" for the
        1d-row layout (replicas over "cols" hold the same block), every
        rank of the mesh for the 2-d layouts."""
        if self.grid is not None:
            return flat_mesh(self.mesh).get_group(0)
        return self.mesh.get_group(ROW_AXIS)

    @property
    def global_nnz(self) -> int:
        """Stored entries over every shard (a host int, exact past 2^31:
        each constructor counts them on the host)."""
        return self.nnz_hint

    def _require_blocks(self, op: str) -> None:
        if self.data is None:
            raise ValueError(
                f"{op} needs ELL/CSR blocks, but this DistCSR is "
                "DIA-only (built with materialize_ell=False); rebuild "
                "with materialize_ell=True")

    def matvec_fn(self):
        """``x_local -> y_local``: the SpMV of this rank's blocks, for
        solver loops."""
        return lambda x: _spmv_local(self, x)

    # ---- back to one matrix (inspection; a collective) ----
    def _local_coo(self):
        """(global rows, global cols, values) of this rank's stored
        entries, as host numpy arrays."""
        rps = self.rows_per_shard
        if self.data is None:
            return self._dia_coo()
        if self.grid is not None:
            Rc = self.grid[1]
            i, j = divmod(mesh_position(self.mesh), Rc)
            ln = int(self.counts)
            return (to_numpy(self.row_ids[:ln]).astype(np.int64) + i * rps,
                    to_numpy(self.cols[:ln]).astype(np.int64)
                    + j * self.cols_per_shard,
                    to_numpy(self.data[:ln]))
        r, c, v = _local_entries(self)
        return (to_numpy(r) + self.shard * rps, to_numpy(c), to_numpy(v))

    def _dia_coo(self):
        rows, cols = self.shape
        rps = self.rows_per_shard
        r = np.arange(rps, dtype=np.int64) + self.shard * rps
        ddata = to_numpy(self.dia_data)
        dmask = (to_numpy(self.dia_mask) if self.dia_mask is not None
                 else None)
        out_r, out_c, out_v = [], [], []
        for d, o in enumerate(self.dia_offsets):
            c = r + o
            valid = (c >= 0) & (c < cols) & (r < rows)
            if dmask is not None:
                valid &= dmask[d]
            out_r.append(r[valid])
            out_c.append(c[valid])
            out_v.append(ddata[d][valid])
        return (np.concatenate(out_r), np.concatenate(out_c),
                np.concatenate(out_v))

    def to_csr(self):
        """The whole matrix as a ``csr_array`` on this rank's device,
        gathered from every shard (every rank must call it; inspection,
        O(global nnz) on each host)."""
        from ..csr import csr_array

        parts = [None] * dist.get_world_size(self.vector_group)
        dist.all_gather_object(parts, self._local_coo(),
                               group=self.vector_group)
        r, c, v = (np.concatenate([p[k] for p in parts]) for k in range(3))
        keep = (r < self.shape[0]) & (c < self.shape[1])
        vals = torch.from_numpy(np.ascontiguousarray(v[keep])).to(self.dtype)
        return csr_array((vals, (r[keep], c[keep])), shape=self.shape,
                         device=self.device)

    def toscipy(self):
        return self.to_csr().toscipy()


# ----------------------------------------------------------- structure --

def _local_entries(A: DistCSR):
    """This rank's stored entries of a 1d-row layout in storage order
    (row-major, each row's slots in order) as tensors on its device:
    local row (int64), global column (int64, rebased from the halo
    window or the precise plan's compact buffer) and value
    (``_a_local_flat``, ``dist_spgemm.py:87``)."""
    A._require_blocks("this operation")
    rps, dev = A.rows_per_shard, A.data.device
    if A.ell:
        W = A.cols.shape[1]
        valid = (torch.arange(W, device=dev)[None, :] < A.counts[:, None])
        r = torch.arange(rps, device=dev)[:, None].expand(rps, W)[valid]
        c, v = A.cols[valid].to(torch.int64), A.data[valid]
    else:
        ln = int(A.counts)
        r = A.row_ids[:ln].to(torch.int64)
        c, v = A.cols[:ln].to(torch.int64), A.data[:ln]
    start = A.shard * rps
    if A.gather_globals is not None:
        base = A.gather_globals.reshape(-1).to(torch.int64)
        rc = base.shape[0]
        c = torch.where(c < rc, base[torch.clamp(c, 0, rc - 1)],
                        c - rc + A.shard * A.cols_per_shard)
    elif A.halo >= 0:
        c = c + (start - A.halo)
    return r, c, v


def attach_dia_prepack(A: DistCSR) -> DistCSR:
    """The DIA kernel's pack of this rank's band over the halo-extended
    window, in place: ``rdata`` the (nd, rps) band, offsets shifted by
    +halo, shape (rps, rps + 2 halo), and one int8 mask that merges the
    global row and column bounds, the padding rows and the band's holes
    (the ring-wrapped halo never reaches y, not even as 0 * inf).  A
    no-op when built already, not banded, or outside the kernel's gate
    (``dia_kernel.supported`` of the shifted offsets)."""
    if (A.dia_pack is not None or A.dia_data is None or A.halo < 0
            or A.dia_offsets is None):
        return A
    offs2 = tuple(int(o) + A.halo for o in A.dia_offsets)
    if not _dia_kernel.supported(offs2, A.dtype):
        return A
    nd, rps = A.dia_data.shape
    n_rows = A.shape[0]
    dev = A.dia_data.device
    r_g = (A.shard * rps + torch.arange(rps, device=dev)).reshape(1, rps)
    offs = torch.tensor(A.dia_offsets, device=dev).reshape(nd, 1)
    valid = (r_g + offs >= 0) & (r_g + offs < n_rows) & (r_g < n_rows)
    if A.dia_mask is not None:
        valid = valid & A.dia_mask
    A.dia_pack = _dia_kernel.PackedBand(
        A.dia_data.contiguous(), valid.to(torch.int8).contiguous(), offs2,
        (rps, rps + 2 * A.halo))
    return A


def _precise_gather_plan(indices, indptr, starts, ends, R, cps, cols):
    """Per-shard precise image (``dist_csr.py:404-455``): the unique
    x entries each shard reads, as an all_to_all send plan, and the
    rebase global col -> compact buffer position.  Returns (gather_idx
    (R_src, R_dst, C), gather_globals (R_dst, R_src, C), rebase)."""
    needed = []
    C = 1
    for s in range(R):
        win = np.unique(indices[indptr[starts[s]]: indptr[ends[s]]])
        per_t = []
        for t in range(R):
            sub = win[(win >= t * cps) & (win < (t + 1) * cps)]
            per_t.append(sub)
            if t != s:
                C = max(C, sub.shape[0])
        needed.append(per_t)
    gather_idx = np.zeros((R, R, C), dtype=np.int32)
    for s in range(R):
        for t in range(R):
            if t != s:
                sub = needed[s][t]
                gather_idx[t, s, : sub.shape[0]] = sub - t * cps
    gather_globals = (np.transpose(gather_idx, (1, 0, 2)).astype(np.int64)
                      + (np.arange(R, dtype=np.int64) * cps)[None, :, None])

    def rebase(s, cols_global):
        flat = cols_global.reshape(-1)
        t_of = np.clip(flat // cps, 0, R - 1)
        res = np.empty(flat.shape[0], dtype=np.int64)
        for t in range(R):
            m = t_of == t
            if not m.any():
                continue
            if t == s:
                res[m] = R * C + (flat[m] - s * cps)
            else:
                res[m] = t * C + np.searchsorted(needed[s][t], flat[m])
        return np.clip(res.reshape(cols_global.shape), 0, R * C + cps - 1)

    return gather_idx, gather_globals, rebase


def _dia_shard_block(offs, dia_global, start, rps, rows, cols):
    """This shard's DIA block: block[d, r] = A[start+r, start+r+o_d]
    from scipy-layout ``dia_global`` (0 outside the matrix and on
    padding rows)."""
    dev = dia_global.device
    r = start + torch.arange(rps, dtype=torch.int64, device=dev)
    out = torch.zeros((len(offs), rps), dtype=dia_global.dtype, device=dev)
    for d, o in enumerate(offs):
        src = r + o
        valid = (src >= 0) & (src < cols) & (r < rows)
        out[d, valid] = dia_global[d, src[valid]]
    return out


def _grid_of(mesh, layout: str) -> Tuple[int, int]:
    """The (Rr, Rc) grid a 2-d-family layout uses on ``mesh`` (every
    rank when None)."""
    n = mesh.size() if mesh is not None else dist.get_world_size()
    if layout == LAYOUT_1D_COL:
        return (1, n)
    if mesh is not None and mesh.ndim == 2 and mesh.size(0) > 1:
        return (mesh.size(0), mesh.size(1))
    return factor_grid(n)


def _grid_mesh_for(mesh, grid: Tuple[int, int]):
    """``mesh`` when it is the (rows, cols) grid ``grid``, else that grid
    over ``mesh``'s ranks (every rank when None)."""
    if (mesh is not None and mesh.mesh_dim_names == (ROW_AXIS, COL_AXIS)
            and tuple(mesh.shape) == tuple(grid)):
        return mesh
    ranks = None if mesh is None else mesh_ranks(mesh)
    return _mesh(tuple(grid), (ROW_AXIS, COL_AXIS), ranks)


def _predict_1d_spmv_bytes(rows: int, cols: int, indptr, indices,
                           R: int, itemsize: int) -> int:
    """Predicted per-call x-realization bytes of the 1d-row SpMV at
    shard count ``R`` (``dist_csr.py:517``)."""
    rps = math.ceil(rows / R) if rows else 1
    if rows == cols and rows:
        starts = np.minimum(np.arange(R) * rps, rows)
        ends = np.minimum(starts + rps, rows)
        lo, hi = indptr[starts], indptr[ends]
        h = 0
        for s in range(R):
            if hi[s] > lo[s]:
                win = indices[lo[s]:hi[s]]
                h = max(h, int(max(starts[s] - win.min(),
                                   win.max() + 1 - ends[s], 0)))
        if h <= rps:
            return _comm.halo_exchange_bytes(h, itemsize, R)
    return _comm.all_gather_bytes(rps, itemsize, R)


def _route_layout(A, mesh) -> str:
    """``"auto"``: 2d-block where its predicted per-SpMV bytes strictly
    beat the 1d-row prediction at the same rank count, recorded as a
    ``shard_csr.routing`` event (``dist_csr.py:541``)."""
    rows, cols = A.shape
    grid = _grid_of(mesh, LAYOUT_2D_BLOCK)
    Rr, Rc = grid
    N = Rr * Rc
    item = A.dtype.itemsize
    bytes_1d = _predict_1d_spmv_bytes(rows, cols, to_numpy(A.indptr),
                                      to_numpy(A.indices), N, item)
    rows_p = N * max(-(-rows // N), 1)
    cols_p = N * max(-(-cols // N), 1)
    bytes_2d = _comm.total(_comm.spmv_volumes_2d(
        grid_rows=Rr, grid_cols=Rc, spc=cols_p // N, rps=rows_p // Rr,
        itemsize=item))
    choice = LAYOUT_2D_BLOCK if bytes_2d < bytes_1d else LAYOUT_1D_ROW
    _trace.event("shard_csr.routing", layout=choice, shards=N, grid=grid,
                 rows=rows, nnz=A.nnz, predicted_1d_bytes=bytes_1d,
                 predicted_2d_bytes=bytes_2d)
    return choice


def _shard_csr_2d(A, mesh, layout: str) -> DistCSR:
    """2-d block partition (``dist_csr.py:571-651``): rank (i, j) of the
    (Rr, Rc) grid holds rows [i rps, (i+1) rps) x cols [j cps, (j+1) cps)
    as padded CSR with block-local columns; rows and columns padded to a
    multiple of Rr Rc."""
    grid = _grid_of(mesh, layout)
    mesh = _grid_mesh_for(mesh, grid)
    Rr, Rc = grid
    N = Rr * Rc
    rows, cols = A.shape
    rows_p = N * max(-(-rows // N), 1)
    cols_p = N * max(-(-cols // N), 1)
    rps, cps = rows_p // Rr, cols_p // Rc
    i, j = mesh.get_local_rank(ROW_AXIS), mesh.get_local_rank(COL_AXIS)
    row_ids = A._get_row_ids()
    col = A.indices.to(torch.int64)
    mine = ((row_ids // rps == i) & (col // cps == j))
    col_dt = torch.int16 if cps - 1 <= 32767 else torch.int32
    per_block = torch.bincount((row_ids // rps) * Rc + col // cps,
                               minlength=N)
    ln = int(mine.sum())
    cap = max(ln, 1)
    dev = mesh_device(mesh)
    data = torch.zeros((cap,), dtype=A.dtype, device=A.device)
    cols_b = torch.zeros((cap,), dtype=col_dt, device=A.device)
    rid = torch.full((cap,), max(rps - 1, 0), dtype=torch.int32,
                     device=A.device)
    data[:ln] = A.data[mine]
    cols_b[:ln] = (col[mine] - j * cps).to(col_dt)
    rid[:ln] = (row_ids[mine] - i * rps).to(torch.int32)
    _trace.event("shard_csr.layout", layout=layout, halo=-1, precise=False,
                 shards=N, rows=rows, nnz=A.nnz, banded=False, grid=grid)
    return DistCSR(
        data=data.to(dev), cols=cols_b.to(dev),
        counts=torch.tensor(ln, dtype=torch.int32, device=dev),
        row_ids=rid.to(dev), shape=(rows, cols), rows_per_shard=rps,
        halo=-1, ell=False, mesh=mesh, cols_per_shard=cps,
        nnz_hint=A.nnz, layout=layout, grid=grid,
        nnz_cap=max(int(per_block.max()), 1) if A.nnz else 1, _src_csr=A)


def shard_csr(A, mesh=None, force_all_gather: bool = False,
              ell_max_expand: Optional[float] = None,
              precise: Optional[bool] = None,
              layout: Optional[str] = None) -> DistCSR:
    """Partition a ``csr_array`` over a mesh (``dist_csr.py:653-900``).
    Every rank calls it with the same matrix and builds only its own
    shard, on its own device.

    ``layout``: ``"1d-row"`` (row blocks, x realized by halo exchange,
    all-gather or the precise plan), ``"1d-col"``/``"2d-block"`` (the
    block grid: x panels gathered along mesh rows, partial products
    reduce-scattered along mesh columns) or ``"auto"``; the argument,
    else ``LEGATE_SPARSE_TPU_DIST_LAYOUT``, else "1d-row".  The 1d-row
    build takes the halo window when every shard's columns reach at most
    one row block past its own; a banded matrix in halo mode also
    carries DIA blocks and their kernel pack."""
    from ..settings import settings

    _obs_counters.handle("op.shard_csr").inc()
    if precise and force_all_gather:
        raise ValueError(
            "shard_csr: precise=True conflicts with force_all_gather=True "
            "— the two request different x realizations; pass at most one")
    lay = resolve_layout(layout)
    if lay == LAYOUT_AUTO:
        lay = _route_layout(A, mesh)
    if lay in (LAYOUT_2D_BLOCK, LAYOUT_1D_COL):
        if precise:
            raise ValueError(
                f"shard_csr: precise images are a 1d-row realization; "
                f"not supported with layout={lay!r}")
        return _shard_csr_2d(A, mesh, lay)
    if ell_max_expand is None:
        ell_max_expand = settings.ell_max_expand
    if precise is None:
        precise = settings.precise_images and not force_all_gather
    if mesh is None:
        mesh = make_row_mesh()
    R = mesh.size(0)
    s = mesh.get_local_rank(ROW_AXIS)
    dev = mesh_device(mesh)
    rows, cols = A.shape
    rps = math.ceil(rows / R) if rows else 1
    indptr = to_numpy(A.indptr).astype(np.int64)
    indices = to_numpy(A.indices)
    counts = np.diff(indptr)
    nnz = int(indptr[-1])
    starts = np.minimum(np.arange(R) * rps, rows)
    ends = np.minimum(starts + rps, rows)

    # Column windows per shard.
    col_min = np.zeros(R, dtype=np.int64)
    col_max = np.zeros(R, dtype=np.int64)
    lo, hi = indptr[starts], indptr[ends]
    for t in range(R):
        if hi[t] > lo[t]:
            win = indices[lo[t]:hi[t]]
            col_min[t], col_max[t] = win.min(), win.max()
        else:
            col_min[t] = col_max[t] = min(starts[t], max(cols - 1, 0))

    gather_idx = gather_globals = rebase = None
    cps = math.ceil(cols / R) if cols else 1
    if precise:
        gather_idx, gather_globals, rebase = _precise_gather_plan(
            indices, indptr, starts, ends, R, cps, cols)

    halo = -1
    if rows == cols and not force_all_gather and not precise:
        h = int(max(np.maximum(starts - col_min, 0).max(),
                    np.maximum(col_max + 1 - ends, 0).max()))
        if h <= rps:
            halo = h
        else:
            gi, gg, rb = _precise_gather_plan(indices, indptr, starts, ends,
                                              R, cps, cols)
            if R * gi.shape[-1] + cps < R * rps:
                precise = True
                gather_idx, gather_globals, rebase = gi, gg, rb

    dia_offs = dia_block = dia_mask_block = None
    if halo >= 0:
        dia_cache = A._get_dia()
        if dia_cache is not None:
            dia_dev, offs_t, mask_dev = dia_cache
            mo = int(max(max(offs_t, default=0), -min(offs_t, default=0)))
            if mo <= rps:
                halo = max(halo, mo)
                dia_offs = offs_t
                dia_block = _dia_shard_block(offs_t, dia_dev, s * rps, rps,
                                             rows, cols).to(dev)
                if mask_dev is not None:
                    dia_mask_block = _dia_shard_block(
                        offs_t, mask_dev, s * rps, rps, rows, cols).to(dev)

    # This shard's CSR slice, its rows padded to rps.
    a, b = int(lo[s]), int(hi[s])
    n_loc = int(ends[s] - starts[s])
    indptr_l = A.indptr[starts[s]:ends[s] + 1].to(torch.int64) - a
    indptr_l = torch.cat([indptr_l, indptr_l[-1:].expand(rps - n_loc)])
    data_l, idx_l = A.data[a:b], A.indices[a:b]
    W = max(int(counts.max()), 1) if rows and nnz else 1
    use_ell = _spmv_ops.ell_within_budget(R * rps, W, nnz, ell_max_expand)

    def localize(c):
        """Global columns (A's index dtype) -> this layout's columns."""
        if precise:
            return torch.from_numpy(rebase(s, to_numpy(c).astype(
                np.int64)).astype(np.int32)).to(c.device)
        if halo >= 0:
            return torch.clamp(c.to(torch.int64) - (s * rps - halo), 0,
                               rps + 2 * halo - 1).to(idx_l.dtype)
        return c

    if use_ell:
        e_data, e_cols, e_counts = _spmv_ops.ell_pack(data_l, idx_l,
                                                      indptr_l, rps, W)
        blocks = dict(data=e_data, cols=localize(e_cols), counts=e_counts,
                      row_ids=None)
    else:
        ln = b - a
        cap = max(int((hi - lo).max()), 1) if nnz else 1
        pad = cap - ln
        rid = torch.repeat_interleave(
            torch.arange(rps, dtype=torch.int32, device=A.device),
            indptr_l[1:] - indptr_l[:-1], output_size=ln)
        blocks = dict(
            data=torch.cat([data_l, data_l.new_zeros(pad)]),
            cols=localize(torch.cat([idx_l, idx_l.new_zeros(pad)])),
            counts=torch.tensor(ln, dtype=torch.int32),
            row_ids=torch.cat([rid, rid.new_full((pad,), max(rps - 1, 0))]))
    _trace.event("shard_csr.layout", layout="ell" if use_ell else
                 "padded-csr", halo=halo, precise=bool(precise), shards=R,
                 rows=rows, nnz=nnz, banded=dia_offs is not None)

    def put(t):
        return t.to(dev).contiguous() if t is not None else None

    return attach_dia_prepack(DistCSR(
        **{k: put(v) for k, v in blocks.items()}, shape=(rows, cols),
        rows_per_shard=rps, halo=halo, ell=use_ell, mesh=mesh,
        gather_idx=(put(torch.from_numpy(gather_idx[s]).to(torch.int64))
                    if precise else None),
        gather_globals=(put(torch.from_numpy(gather_globals[s]))
                        if precise else None),
        cols_per_shard=cps, dia_data=dia_block, dia_offsets=dia_offs,
        dia_mask=dia_mask_block, nnz_hint=nnz, _src_csr=A))


# -------------------------------------------------------------- vectors --

def _vector_mesh(mesh, layout: str):
    """(mesh, placements) of a vector of ``layout`` on ``mesh``."""
    from torch.distributed.tensor import Shard

    if layout in (LAYOUT_2D_BLOCK, LAYOUT_1D_COL):
        return flat_mesh(mesh), (Shard(0),)
    return mesh, row_sharding(mesh)


def _chunk_index(mesh, layout: str) -> int:
    if layout in (LAYOUT_2D_BLOCK, LAYOUT_1D_COL):
        return mesh_position(mesh)
    return mesh.get_local_rank(ROW_AXIS)


def _dtensor(local: torch.Tensor, mesh, placements, shape):
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def _global_vector(A: DistCSR, local: torch.Tensor, length: int):
    """This rank's block of a vector (or of an (n, k) block of vectors)
    as the DTensor of its first ``length`` rows."""
    vmesh, placements = _vector_mesh(A.mesh, A.layout)
    L = local.shape[0]
    start = _chunk_index(A.mesh, A.layout) * L
    keep = max(0, min(L, length - start))
    return _dtensor(local[:keep], vmesh, placements,
                    (length,) + tuple(local.shape[1:]))


def _local(x) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _global_host(x, device) -> torch.Tensor:
    """An array-like (or a DTensor, gathered) as a whole tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return as_tensor(x, device)


def _local_rows(x: torch.Tensor, L: int, k: int, total: int):
    """Rows [k L, (k+1) L) of ``x`` zero-padded to ``total`` rows."""
    pad = total - x.shape[0]
    if pad > 0:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x[k * L:(k + 1) * L].contiguous()


def shard_vector(x, mesh, rows_padded: int, layout: str = LAYOUT_1D_ROW):
    """``x`` padded to ``rows_padded`` and laid out per the matrix
    layout: row blocks over "rows" (1d-row), chunk k on rank k (2-d)."""
    x = _global_host(x, mesh_device(mesh))
    vmesh, placements = _vector_mesh(mesh, layout)
    n_chunks = vmesh.size(0)
    L = rows_padded // n_chunks
    local = _local_rows(x, L, _chunk_index(mesh, layout), rows_padded)
    return _dtensor(local, vmesh, placements, (rows_padded,))


def shard_dense(X, mesh, rows_padded: int):
    """A dense (rows, k) operand padded and sharded: rows over "rows",
    columns over "cols" too on a 2-D grid mesh (k padded to a multiple
    of its size)."""
    from torch.distributed.tensor import Shard

    X = _global_host(X, mesh_device(mesh))
    R = mesh.size(0)
    L = rows_padded // R
    local = _local_rows(X, L, mesh.get_local_rank(ROW_AXIS), rows_padded)
    k = X.shape[1]
    if mesh.ndim == 2:
        C = mesh.size(1)
        pad_c = (-k) % C
        if pad_c:
            local = torch.cat([local, local.new_zeros((L, pad_c))], dim=1)
        kc = (k + pad_c) // C
        j = mesh.get_local_rank(COL_AXIS)
        return _dtensor(local[:, j * kc:(j + 1) * kc].contiguous(), mesh,
                        (Shard(0), Shard(1)), (rows_padded, k + pad_c))
    return _dtensor(local, mesh, (Shard(0),), (rows_padded, k))


def mesh_fingerprint(mesh, layout: Optional[str] = None) -> str:
    """Stable identity of the ranks behind a mesh: axis names, shape and
    every member's (device type, rank), as the JAX package's
    ``(platform, id)`` (``dist_csr.py:921``)."""
    devs = tuple((mesh.device_type, int(r))
                 for r in mesh.mesh.reshape(-1).tolist())
    desc = repr((tuple(mesh.mesh_dim_names), tuple(mesh.shape), devs)
                + ((layout,) if layout is not None else ()))
    return hashlib.sha1(desc.encode()).hexdigest()[:16]


def dist_plan_fingerprint(A: DistCSR) -> str:
    """Mesh fingerprint plus the layout terms that select a distinct
    collective program (``dist_csr.py:946``); ``t`` is 1 where the DIA
    kernel pack is built (the JAX package writes its tile size)."""
    precise = A.gather_idx is not None
    grid = "-" if A.grid is None else f"{A.grid[0]}x{A.grid[1]}"
    return (f"{mesh_fingerprint(A.mesh, layout=A.layout)}"
            f":h{A.halo}:e{int(A.ell)}:p{int(precise)}"
            f":r{A.rows_per_shard}:d{int(A.dia_data is not None)}"
            f":t{int(A.dia_pack is not None)}:g{grid}")


# ---------------------------------------------------------- collectives --

def _ring(group):
    """(size, left, right) of this rank on ``group``'s ring, as global
    ranks (looked up once a group of the job)."""
    cache = job_cache()
    if ("ring", group) not in cache:
        ranks = dist.get_process_group_ranks(group)
        me = ranks.index(dist.get_rank())
        R = len(ranks)
        cache[("ring", group)] = (R, ranks[(me - 1) % R],
                                  ranks[(me + 1) % R])
    return cache[("ring", group)]


def _extend_x(x_local: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Halo exchange (``dist_csr.py:962``): the left neighbour's last
    ``halo`` rows, this block, the right neighbour's first ``halo``
    rows, around the ring (the first shard's left neighbour is the
    last).  Where the neighbour is the rank itself the exchange is a
    local copy; at two ranks both messages go to one peer, told apart
    by their tags."""
    if halo <= 0:
        return x_local
    n = x_local.shape[0]
    tail = x_local[n - halo:].contiguous()
    head = x_local[:halo].contiguous()
    R, left, right = _ring(group)
    if R == 1:
        return torch.cat([tail, x_local, head])
    from_left, from_right = torch.empty_like(tail), torch.empty_like(head)
    ops = [dist.P2POp(dist.isend, tail, right, group, 0),
           dist.P2POp(dist.isend, head, left, group, 1),
           dist.P2POp(dist.irecv, from_left, left, group, 0),
           dist.P2POp(dist.irecv, from_right, right, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([from_left, x_local, from_right])


# The tensor forms of all-gather and reduce-scatter, under the names
# the installed torch offers without a deprecation warning.
_all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _all_gather(x_local: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-gather along dim 0."""
    R = dist.get_world_size(group)
    out = x_local.new_empty((R * x_local.shape[0],)
                            + tuple(x_local.shape[1:]))
    _all_gather_into(out, x_local.contiguous(), group=group)
    return out


def _realize(A: DistCSR, x_local: torch.Tensor) -> torch.Tensor:
    """This shard's x source (``realize``, ``dist_csr.py:1092``): the
    precise plan's compact buffer, the halo window or the all-gathered
    x."""
    group = A.mesh.get_group(ROW_AXIS)
    if A.gather_idx is not None:
        send = x_local[A.gather_idx].contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return torch.cat([recv.reshape((-1,) + tuple(x_local.shape[1:])),
                          x_local])
    if A.halo >= 0:
        return _extend_x(x_local, A.halo, group)
    return _all_gather(x_local, group)


def _transpose_chunks(A: DistCSR, x_local: torch.Tensor) -> torch.Tensor:
    """The chunk transpose of the 2-d SpMV's input (``dist_csr.py:1148``):
    the rank at mesh position i Rc + j gets chunk j Rr + i.  No message
    on a 1-D grid."""
    Rr, Rc = A.grid
    ranks = mesh_ranks(A.mesh)
    me = mesh_position(A.mesh)
    i, j = divmod(me, Rc)
    src = j * Rr + i
    dst = (me % Rr) * Rc + me // Rr
    if src == me and dst == me:
        return x_local
    buf = torch.empty_like(x_local)
    ops = [dist.P2POp(dist.isend, x_local.contiguous(), ranks[dst]),
           dist.P2POp(dist.irecv, buf, ranks[src])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


# ------------------------------------------------------------- products --

def spmv_comm_volumes(A: DistCSR, x_local_elems: int, itemsize: int,
                      cols: int = 1):
    """Per-call collective volumes of one ``dist_spmv`` (``dist_spmm``
    with ``cols`` > 1) on ``A`` (``dist_csr.py:1367``)."""
    if A.grid is not None:
        return _comm.spmv_volumes_2d(
            grid_rows=A.grid[0], grid_cols=A.grid[1], spc=x_local_elems,
            rps=A.rows_per_shard, itemsize=itemsize)
    precise_C = (int(A.gather_idx.shape[-1])
                 if A.gather_idx is not None else None)
    return _comm.spmv_volumes(
        shards=A.num_shards, halo=A.halo, precise_C=precise_C,
        x_local_elems=x_local_elems, itemsize=itemsize, cols=cols)


def cg_comm_volumes(A: DistCSR, itemsize: int, iters: int):
    """Predicted volumes of an ``iters``-iteration CG on ``A`` as the
    JAX package's fused loop runs it (``dist_csr.py:1391``): ``iters +
    1`` SpMVs and three scalar reductions an iteration.  Returns
    ``(vols, calls)``."""
    R = A.num_shards
    spmv = spmv_comm_volumes(A, A.rows_padded // R, itemsize)
    per_iter = _comm.cg_iteration_volumes(spmv, itemsize, R)
    vols = _comm.merge(_comm.scale(per_iter, iters), spmv)
    calls = {k: iters + 1 for k in spmv}
    calls["psum"] = calls.get("psum", 0) + 3 * iters
    return vols, calls


def _spmv_2d(A: DistCSR, x_local: torch.Tensor):
    """The 2-d block SpMV (``_block_spmv_2d_fn``, ``dist_csr.py:1160``):
    chunk transpose, x panel all-gathered along mesh rows, this block's
    padded-CSR product (f32 accumulation for bf16/f16 blocks), partial
    rows reduce-scattered along mesh columns."""
    lowp = A.dtype in _LOWP
    x_panel = _all_gather(_transpose_chunks(A, x_local),
                          A.mesh.get_group(ROW_AXIS))
    fn = (_spmv_ops.csr_spmv_rowids_masked_f32acc if lowp
          else _spmv_ops.csr_spmv_rowids_masked)
    y_part = fn(A.data, A.cols, A.row_ids, A.counts, x_panel,
                A.rows_per_shard)
    out = y_part.new_empty((A.rows_per_shard // A.grid[1],))
    _reduce_scatter_into(out, y_part.contiguous(),
                         group=A.mesh.get_group(COL_AXIS))
    return out, "2d-block-bf16" if lowp else "2d-block"


def _dia_spmv_torch(A: DistCSR, x_local: torch.Tensor) -> torch.Tensor:
    """The banded SpMV's shifted adds (``_dia_spmv_fn``,
    ``dist_csr.py:987``): per diagonal in offset order, the window's
    slice times the band, products outside the matrix, on padding rows
    and at holes masked to an exact 0."""
    halo, rps = A.halo, A.rows_per_shard
    x_ext = _extend_x(x_local, halo, A.mesh.get_group(ROW_AXIS))
    dd = A.dia_data
    dev = dd.device
    r_g = A.shard * rps + torch.arange(rps, dtype=torch.int64, device=dev)
    n_rows = A.shape[0]
    y = torch.zeros((rps,), dtype=dd.dtype, device=dev)
    zero = torch.zeros((), dtype=dd.dtype, device=dev)
    for d, o in enumerate(A.dia_offsets):
        seg = x_ext[halo + o: halo + o + rps]
        if A.dia_mask is not None:
            valid = A.dia_mask[d]
        else:
            valid = (r_g + o >= 0) & (r_g + o < n_rows) & (r_g < n_rows)
        y = y + torch.where(valid, dd[d] * seg, zero)
    return y


def attach_bsr_prepack(A: DistCSR) -> DistCSR:
    """The BSR structure of this rank's row block, in place
    (``dist_csr.py:1984``): an all-gather (halo < 0), ELL, non-precise,
    f32 matrix whose every shard fits ``bsr_max_expand`` and
    ``MAX_BLOCKS`` (one all-reduce agrees on it); built on a CUDA rank,
    on any under ``settings.bsr_force`` (the plain version then runs on
    the CPU).  The row block's CSR is read back from its ELL slots on
    the rank's device."""
    from ..settings import settings

    if (A.bsr is not None or A.bsr_tried or A.data is None or not A.ell
            or A.halo >= 0 or A.gather_idx is not None
            or settings.bsr_max_expand <= 0 or A.dtype != torch.float32
            or (A.device.type != "cuda" and not settings.bsr_force)):
        return A
    A.bsr_tried = True
    rps, W = A.data.shape
    valid = (torch.arange(W, device=A.data.device)[None, :]
             < A.counts[:, None])
    indptr = torch.zeros((rps + 1,), dtype=torch.int64, device=A.data.device)
    indptr[1:] = torch.cumsum(A.counts.to(torch.int64), 0)
    data, idx = A.data[valid].contiguous(), A.cols[valid].contiguous()
    row_ids = torch.repeat_interleave(
        torch.arange(rps, device=A.data.device), A.counts.to(torch.int64),
        output_size=data.shape[0])
    st = _bsr_ops.build_structure(data, idx, indptr, row_ids,
                                  (rps, A.shape[1]), settings.bsr_max_expand)
    # Every shard takes the route or none does (the JAX package packs
    # all shards or none).
    ok = torch.tensor([int(st is not None)], device=A.data.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=A.vector_group)
    A.bsr = st if int(ok.item()) else None
    return A


def _spmv_local(A: DistCSR, x_local: torch.Tensor) -> torch.Tensor:
    """``y_local`` of ``y = A @ x`` from this rank's block of x: the
    dispatch of ``_dist_spmv_impl`` (``dist_csr.py:1606-1711``)."""
    _obs_counters.handle("op.dist_spmv").inc()
    vols = spmv_comm_volumes(A, int(x_local.shape[0]),
                             x_local.element_size())
    comm_bytes = _comm.record("dist_spmv", vols, layout=A.layout)
    with _tctx.profiler_scope("dist_spmv"), \
            _lat.timer("lat.dist_spmv." + _lat.shape_bucket(A.shape[0])), \
            _trace.span("dist_spmv", shards=A.num_shards, halo=A.halo,
                        comm_bytes=comm_bytes,
                        comm_calls=sum(1 for b in vols.values() if b > 0)
                        ) as sp:
        y, path = _dispatch(A, x_local)
        if sp is not None:
            sp.set(path=path, layout=A.layout,
                   precise=A.gather_idx is not None)
    A.spmv_path = path
    return y


def _dispatch(A: DistCSR, x_local: torch.Tensor):
    if A.grid is not None:
        return _spmv_2d(A, x_local)
    precise = A.gather_idx is not None
    same = torch.promote_types(A.dtype, x_local.dtype) == A.dtype
    if A.dia_data is not None and A.halo >= 0 and not precise:
        if A.dia_pack is not None and same:
            # The dtype gate keeps promotion (bf16 band, f32 x -> f32)
            # to the shifted adds, as the JAX package's does.
            x_ext = _extend_x(x_local.to(A.dtype), A.halo,
                              A.mesh.get_group(ROW_AXIS))
            return _dia_kernel.dia_spmv(A.dia_pack, x_ext), "dia-kernel"
        return _dia_spmv_torch(A, x_local), "dia-torch"
    A._require_blocks("dist_spmv")
    attach_bsr_prepack(A)
    if A.bsr is not None and same:
        x_full = _all_gather(x_local, A.mesh.get_group(ROW_AXIS))
        return A.bsr.matvec(x_full[:A.shape[1]]), "bsr"
    x_src = _realize(A, x_local)
    if A.ell:
        return _spmv_ops.ell_spmv(A.data, A.cols, A.counts, x_src), "ell"
    return _spmv_ops.csr_spmv_rowids_masked(
        A.data, A.cols, A.row_ids, A.counts, x_src,
        A.rows_per_shard), "padded-csr"


# ------------------------------------------------------- semiring arm --

def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the collectives carry it: a bool as its uint8 view
    (neither NCCL nor gloo reduces or, everywhere, moves bool)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(torch.bool) if dtype == torch.bool else t


def semiring_spmv_comm_volumes(A: DistCSR, x_itemsize: int,
                               y_itemsize: int, collective: str,
                               cols: int = 1):
    """Per-call collective volumes of one semiring ``dist_spmv``
    (``dist_spmm`` with ``cols`` > 1) on ``A`` (``dist_csr.py:1415``):
    the 1-d layouts realize x as plus-times does, so
    ``spmv_comm_volumes`` at the x itemsize; the 2-d layouts swap the
    reduce-scatter for the semiring add's all-reduce
    (``obs.comm.spmv_volumes_2d_semiring``)."""
    x_local = A.rows_padded // A.num_shards
    if A.grid is not None:
        return _comm.spmv_volumes_2d_semiring(
            grid_rows=A.grid[0], grid_cols=A.grid[1], spc=x_local,
            rps=A.rows_per_shard, x_itemsize=x_itemsize,
            y_itemsize=y_itemsize, collective=collective)
    precise_C = (int(A.gather_idx.shape[-1])
                 if A.gather_idx is not None else None)
    return _comm.spmv_volumes(
        shards=A.num_shards, halo=A.halo, precise_C=precise_C,
        x_local_elems=x_local * max(cols, 1), itemsize=x_itemsize,
        cols=max(cols, 1))


def _semiring_2d(A: DistCSR, x_local: torch.Tensor, sr) -> torch.Tensor:
    """The 2-d block semiring SpMV (``_block_semiring_spmv_2d_fn``,
    ``dist_csr.py:1287-1340``): chunk transpose and x panel as in
    ``_spmv_2d``, this block's semiring product, then the partial rows
    all-reduced along mesh columns by the add-op and this rank's chunk
    sliced out."""
    Rc = A.grid[1]
    x_panel = _unwire(_all_gather(_transpose_chunks(A, _wire(x_local)),
                                  A.mesh.get_group(ROW_AXIS)), x_local.dtype)
    y_part = _spmv_ops.csr_semiring_spmv_rowids_masked(
        A.data, A.cols, A.row_ids, A.counts, x_panel, A.rows_per_shard,
        sr.add, sr.mul).contiguous()
    op = dist.ReduceOp.MIN if sr.add == "min" else dist.ReduceOp.MAX
    dist.all_reduce(_wire(y_part), op=op, group=A.mesh.get_group(COL_AXIS))
    chunk = A.rows_per_shard // Rc
    j = A.mesh.get_local_rank(COL_AXIS)
    return y_part[j * chunk:(j + 1) * chunk]


def _dist_spmv_semiring(A: DistCSR, x_local: torch.Tensor, sr):
    """The semiring arm of ``dist_spmv`` (``dist_csr.py:1443-1490``): comm
    volumes priced before the dispatch, the ``dist_spmv`` span with its
    path, ``graph.dist_spmv.<name>``; the ELL or padded-CSR blocks, never
    the DIA or BSR route (they hold plus-times arithmetic)."""
    _obs_counters.handle("op.dist_spmv").inc()
    _obs_counters.handle("graph.dist_spmv." + sr.name).inc()
    y_item = (1 if sr.mul == "and" else
              torch.promote_types(A.dtype, x_local.dtype).itemsize)
    vols = semiring_spmv_comm_volumes(A, x_local.element_size(), y_item,
                                      sr.collective)
    comm_bytes = _comm.record("dist_spmv", vols, layout=A.layout)
    precise = A.gather_idx is not None
    with _tctx.profiler_scope("dist_spmv"), \
            _lat.timer("lat.dist_spmv." + _lat.shape_bucket(A.shape[0])), \
            _trace.span("dist_spmv", shards=A.num_shards, halo=A.halo,
                        comm_bytes=comm_bytes,
                        comm_calls=sum(1 for b in vols.values() if b > 0)
                        ) as sp:
        if A.grid is not None:
            y, path = _semiring_2d(A, x_local, sr), "2d-block"
        else:
            A._require_blocks("dist_spmv")
            x_src = _unwire(_realize(A, _wire(x_local)), x_local.dtype)
            if A.ell:
                y, path = _spmv_ops.ell_semiring_spmv(
                    A.data, A.cols, A.counts, x_src, sr.add, sr.mul), "ell"
            else:
                y, path = _spmv_ops.csr_semiring_spmv_rowids_masked(
                    A.data, A.cols, A.row_ids, A.counts, x_src,
                    A.rows_per_shard, sr.add, sr.mul), "padded-csr"
        if sp is not None:
            sp.set(path=path, layout=A.layout, precise=precise,
                   semiring=sr.name)
    A.spmv_path = path
    return y


def _resolve_semiring_arg(semiring):
    """None for plus-times or no semiring (the ordinary program is that
    semiring), else the catalog entry (``dist_csr.py:1493``)."""
    if semiring is None:
        return None
    from ..graph.semiring import resolve

    sr = resolve(semiring)
    if sr.add == "sum" and sr.mul == "times":
        return None
    return sr


def dist_spmv(A: DistCSR, x, semiring=None):
    """y = A @ x.  ``x`` is a sharded vector of length ``A.rows_padded``
    (``shard_vector``), and so is the result; given this rank's local
    block (a plain tensor), the result is this rank's block of y.
    ``semiring`` (a catalog name or ``graph.Semiring``) generalises the
    product; None and ``"plus-times"`` run the ordinary dispatch.

    With ``settings.resil`` the call is the ``dist.spmv`` site (retried
    from its intact operands), and with ``settings.resil_abft`` a
    plus-times product is checksum-verified (``_dist_spmv_abft``)."""
    from torch.distributed.tensor import DTensor

    sr = _resolve_semiring_arg(semiring)
    x_local = _local(x)
    if sr is not None:
        # The checksum identity sum(y) = <w, x> is plus-times algebra:
        # a semiring product retries under the site but runs unchecked.
        if _settings.resil:
            y = _resil_guarded(
                "dist.spmv", lambda: _dist_spmv_semiring(A, x_local, sr))
        else:
            y = _dist_spmv_semiring(A, x_local, sr)
    else:
        y = _guarded_spmv(A, x_local)
    if not isinstance(x, DTensor):
        return y
    return _global_vector(A, y, A.rows_padded)


def _plus_times_spmv(A: DistCSR, x_local: torch.Tensor) -> torch.Tensor:
    # The engine's plan ledger (JAX ``dist_csr.py:1615-1616``): with
    # routing on, every dispatch records against its plan identity.
    # Off (the default), one flag read.
    if _settings.engine:
        from ..engine import get_engine

        get_engine().record_dist_plan(A)
    return _spmv_local(A, x_local)


def _guarded_spmv(A: DistCSR, x_local: torch.Tensor) -> torch.Tensor:
    """The plus-times ``dist_spmv`` of this rank's block: the
    ``dist.spmv`` site when ``settings.resil`` is on (ABFT-checked under
    ``settings.resil_abft``), else the product alone."""
    if not _settings.resil:
        return _plus_times_spmv(A, x_local)
    if _settings.resil_abft:
        return _resil_guarded("dist.spmv",
                              lambda: _dist_spmv_abft(A, x_local))
    return _resil_guarded("dist.spmv",
                          lambda: _plus_times_spmv(A, x_local))


def _abft_checksum_vector(A: DistCSR, xlen: int):
    """This rank's block of the column-checksum vector w (``w_j =
    sum_i A_ij``) an ABFT-checked SpMV dots against x
    (``dist_csr.py:1549``): built once from the kept source matrix on
    the host in f64 (``np.bincount`` sums each column in storage order,
    as ``np.add.at`` does), cast to the matrix's dtype and cached on
    ``A``.  None when the matrix cannot carry one (no kept source, or
    not square: x and y then have no shared partition)."""
    cached = getattr(A, "_abft_w", None)
    if cached is not None and cached[0] == xlen:
        return cached[1]
    src = A._src_csr
    rows, cols = A.shape
    if src is None or rows != cols:
        return None
    wv = np.bincount(to_numpy(src.indices).astype(np.int64),
                     weights=to_numpy(src.data).astype(np.float64),
                     minlength=cols)
    w = torch.from_numpy(wv).to(device=A.device, dtype=A.dtype)
    w = _local_rows(w, xlen, _chunk_index(A.mesh, A.layout), A.rows_padded)
    A._abft_w = (xlen, w)
    return w


def _dist_spmv_abft(A: DistCSR, x_local: torch.Tensor) -> torch.Tensor:
    """The ABFT-checked SpMV (``settings.resil_abft``,
    ``dist_csr.py:1575-1605``): y, then ``sum(y)`` against ``<w, x>``
    with ``<|w|, |x|>`` as the scale, the three partial sums all-reduced
    over the vector group in one call and fetched in one sync.  The
    tolerance is ``64 eps (scale + 1)``, and the NaN-safe ``not (diff <=
    tol)`` makes a poisoned y a detection.  A mismatch raises the
    retryable ``ChecksumError``, which the ``dist.spmv`` site re-runs
    from the intact operands.  A matrix without a checksum vector runs
    unchecked."""
    w = _abft_checksum_vector(A, int(x_local.shape[0]))
    y = _plus_times_spmv(A, x_local)
    if w is None:
        return y
    # A value site: a nonfinite fault poisons y as a corrupted
    # collective would.
    y = _rfaults.fault_point("dist.spmv.abft", y)
    dt = torch.promote_types(A.dtype, x_local.dtype)
    xw = x_local.to(dt)
    stats = torch.stack([y.to(dt).sum(), torch.dot(w.to(dt), xw),
                         torch.dot(w.to(dt).abs(), xw.abs())])
    dist.all_reduce(stats, group=A.vector_group)
    observed, expected, scale = stats.tolist()
    tol = 64.0 * torch.finfo(dt).eps * (abs(scale) + 1.0)
    _obs_counters.inc("resil.abft.checks")
    if not abs(observed - expected) <= tol:
        _obs_counters.inc("resil.abft.mismatch")
        _trace.event("resil.abft.mismatch", observed=observed,
                     expected=expected, tol=tol)
        raise ChecksumError("dist.spmv.abft", observed, expected)
    return y


def _spmm_local(A: DistCSR, X_local: torch.Tensor):
    """``(Y_local, path)`` of ``Y = A @ X`` (``dist_csr.py:1955-1981``)."""
    precise = A.gather_idx is not None
    same = torch.promote_types(A.dtype, X_local.dtype) == A.dtype
    if (A.dia_pack is not None and A.halo >= 0 and not precise and same
            and 0 < X_local.shape[1] <= _dia_kernel.SPMM_MAX_K):
        X_ext = _extend_x(X_local.to(A.dtype).contiguous(), A.halo,
                          A.mesh.get_group(ROW_AXIS))
        return _dia_kernel.dia_spmm(A.dia_pack, X_ext), "dia-kernel"
    X_src = _realize(A, X_local)
    if A.ell:
        return _spmv_ops.ell_spmm(A.data, A.cols, A.counts, X_src), "ell"
    return _spmv_ops.csr_spmm_rowids_masked(
        A.data, A.cols, A.row_ids, A.counts, X_src,
        A.rows_per_shard), "padded-csr"


def _spmm_semiring_local(A: DistCSR, X_local: torch.Tensor, sr):
    """``(Y_local, path)`` of the semiring SpMM (``_block_semiring_spmm_fn``,
    ``dist_csr.py:1808-1871``): k stacked sources in one realization and
    one product, column by column the semiring SpMV."""
    X_src = _unwire(_realize(A, _wire(X_local)), X_local.dtype)
    if A.ell:
        return _spmv_ops.ell_semiring_spmm(
            A.data, A.cols, A.counts, X_src, sr.add, sr.mul), "ell"
    return _spmv_ops.csr_semiring_spmm_rowids_masked(
        A.data, A.cols, A.row_ids, A.counts, X_src, A.rows_per_shard,
        sr.add, sr.mul), "padded-csr"


def dist_spmm(A: DistCSR, X, semiring=None):
    """Y = A @ X for a dense (rows_padded, k) operand sharded by
    ``shard_dense`` (rows over "rows", columns over "cols" on a grid
    mesh); a plain tensor is this rank's block.  1d-row layouts only, as
    in the JAX package.  A banded matrix in halo mode with k <=
    ``SPMM_MAX_K`` takes the DIA SpMM kernel on the window.
    ``semiring`` generalises the product as in ``dist_spmv`` (the
    batched multi-source frontier)."""
    from torch.distributed.tensor import DTensor

    if A.grid is not None:
        raise NotImplementedError(
            "dist_spmm: 2-d-block layouts are SpMV/SpGEMM-only; "
            "shard with layout='1d-row' for dense operands")
    A._require_blocks("dist_spmm")
    _obs_counters.handle("op.dist_spmm").inc()
    X_local = _local(X)
    k_loc = int(X_local.shape[1])
    _comm.record("dist_spmm", spmv_comm_volumes(
        A, int(X_local.shape[0]) * max(k_loc, 1), X_local.element_size(),
        cols=max(k_loc, 1)))
    sr = _resolve_semiring_arg(semiring)
    if sr is not None:
        _obs_counters.handle("graph.dist_spmm." + sr.name).inc()
        Y, A.spmm_path = _spmm_semiring_local(A, X_local, sr)
    else:
        Y, A.spmm_path = _spmm_local(A, X_local)
    if not isinstance(X, DTensor):
        return Y
    return _dtensor(Y, X.device_mesh, X.placements, tuple(X.shape))


def dist_diagonal(A: DistCSR):
    """diag(A) as a sharded vector of length ``rows_padded`` (square A;
    ``dist_csr.py:2436``)."""
    if A.grid is not None:
        raise NotImplementedError(
            "dist_diagonal: 2-d-block layouts are SpMV/SpGEMM-only; "
            "shard with layout='1d-row' for GMG/diagonal consumers")
    rps = A.rows_per_shard
    if A.dia_data is not None:
        if 0 in A.dia_offsets:
            d = A.dia_data[A.dia_offsets.index(0)].contiguous()
        else:
            d = A.dia_data.new_zeros((rps,))
        return _global_vector(A, d, A.rows_padded)
    A._require_blocks("dist_diagonal")
    s = A.shard
    dev = A.data.device
    cols = A.cols.to(torch.int64)
    if A.gather_globals is not None:
        base = A.gather_globals.reshape(-1)
        rc = base.shape[0]
        g = torch.where(cols < rc, base[torch.clamp(cols, 0, rc - 1)],
                        cols - rc + s * A.cols_per_shard)
    elif A.halo >= 0:
        g = cols + (s * rps - A.halo)
    else:
        g = cols
    zero = torch.zeros((), dtype=A.dtype, device=dev)
    if A.ell:
        W = A.cols.shape[1]
        row_g = s * rps + torch.arange(rps, device=dev)
        hit = ((torch.arange(W, device=dev)[None, :] < A.counts[:, None])
               & (g == row_g[:, None]))
        d = torch.where(hit, A.data, zero).sum(dim=1)
    else:
        slot = torch.arange(A.data.shape[0], device=dev)
        hit = (slot < A.counts) & (g == A.row_ids.to(torch.int64) + s * rps)
        d = torch.zeros((rps,), dtype=A.dtype, device=dev).index_add_(
            0, A.row_ids.to(torch.int64), torch.where(hit, A.data, zero))
    return _global_vector(A, d, A.rows_padded)


# -------------------------------------------------------------- solvers --

def _shard_system(A: DistCSR, b, x0, maxiter, callback, M):
    """The solvers' preamble (``dist_csr.py:2116``): this rank's blocks
    of ``b`` and ``x0`` padded to ``rows_padded``, the iteration budget
    (10 rows by default), the callback, which sees the iterate as a
    sharded vector of the true row count, and the preconditioner.  The
    caller's ``M`` and callback run outside the solve's reductions
    (``linalg.outside_reductions``)."""
    from ..linalg import outside_reductions

    rows = A.shape[0]
    dev = A.device
    bt = _global_host(b, dev)
    L = A.local_len
    k = _chunk_index(A.mesh, A.layout)
    b_loc = _local_rows(bt, L, k, A.rows_padded)
    x0_loc = (_local_rows(_global_host(x0, dev).to(bt.dtype), L, k,
                          A.rows_padded) if x0 is not None else None)
    if maxiter is None:
        maxiter = rows * 10
    cb = (None if callback is None else outside_reductions(
        lambda xk: callback(_global_vector(A, xk, rows))))
    M_loc = _identity if M is None else outside_reductions(M)
    return rows, b_loc, x0_loc, int(maxiter), cb, M_loc


@contextlib.contextmanager
def _reductions(A: DistCSR, op: str):
    """The solve's inner products and norms all-reduced over the vector
    group (``linalg.reduce_over``), their count and bytes recorded as
    ``comm.<op>.psum`` when the solve ends."""
    from .. import linalg

    with linalg.reduce_over(A.vector_group) as stats:
        yield
    if stats["calls"]:
        _comm.record(op, {"psum": stats["bytes"]},
                     calls={"psum": stats["calls"]}, layout=A.layout)


def _identity(r):
    return r


@contextlib.contextmanager
def _maybe_ckpt_scope(site: str):
    """A checkpoint scope for a distributed solve when the knob asks for
    one (``settings.resil_ckpt_iters > 0``) and the caller bound none
    (``dist_csr.py:2133``): the caller's scope always wins."""
    if (_settings.resil and _rckpt.current() is None
            and _settings.resil_ckpt_iters > 0):
        with _rckpt.scope(site) as ck:
            yield ck
    else:
        yield _rckpt.current()


def _block_bytes(A: DistCSR) -> int:
    """Bytes of this rank's blocks of ``A`` on its device (the DIA
    kernel pack adds its int8 mask; its band is ``dia_data``)."""
    parts = [getattr(A, name) for name in (
        "data", "cols", "counts", "row_ids", "gather_idx",
        "gather_globals", "dia_data", "dia_mask")]
    if A.dia_pack is not None:
        parts.append(A.dia_pack.rmask)
    return int(sum(t.numel() * t.element_size() for t in parts
                   if t is not None))


def _solve_with_recovery(site: str, A: DistCSR, b_glob: torch.Tensor,
                         x0_glob: torch.Tensor, maxiter: int, solve_fn,
                         guard: bool = True):
    """The device-loss recovery ladder around a distributed solve
    (``dist_csr.py:2146-2235``): **detect** (a ``DeviceLost`` escapes
    the retry policy unretried, at a convergence fetch) -> **shrink**
    (``survivor_mesh`` drops the lost ordinal) -> **reshard** (the kept
    source repartitioned onto the survivors) -> **restore** (the last
    checkpoint's iterate, else the original ``x0``) -> **resume** with
    the rest of the iteration budget.

    ``solve_fn(A_cur, b_local, x0_local, miter) -> (x_local, iters)``
    solves over ``A_cur``'s blocks; ``b_glob``/``x0_glob`` are the whole
    vectors (length ``rows``), from which the ladder cuts each new
    partition's blocks.  ``guard`` makes each attempt the ``site``
    fault/retry site (``dist_gmres`` passes False: its cycles are the
    ``solver.gmres.conv`` site).

    SPMD: every rank armed the same schedule, so every rank sees the
    loss at the same fetch.  All build the survivor mesh (a collective
    of the whole job); the lost rank then leaves the solve raising
    ``DeviceLost`` and takes part in no later collective of it, as a
    lost device could not.  A single-shard solve re-raises at once.
    On the survivors, per recovery: one each of
    ``resil.recovery.attempts``, ``.device_loss`` and ``.mesh_shrink``,
    ``.restored_iters`` by the snapshot's iterations, ``.reshard_bytes``
    by the bytes of the survivors' new blocks (summed over them), one
    ``resil.recovery`` event; ``.succeeded`` once when a recovered solve
    completes.  Returns ``(x_local, total iterations, A_fin)``."""
    from .reshard import reshard

    rows = A.shape[0]
    ck = _rckpt.current()
    A_cur = A
    b_cur = _local_rows(b_glob, A.local_len, _chunk_index(A.mesh, A.layout),
                        A.rows_padded)
    x0_cur = _local_rows(x0_glob, A.local_len,
                         _chunk_index(A.mesh, A.layout), A.rows_padded)
    miter = int(maxiter)
    base = 0          # iterations credited from restored snapshots
    recovered = 0
    while True:
        try:
            if guard:
                x, iters = _resil_guarded(
                    site, lambda: solve_fn(A_cur, b_cur, x0_cur, miter))
            else:
                x, iters = solve_fn(A_cur, b_cur, x0_cur, miter)
            if recovered:
                _obs_counters.inc("resil.recovery.succeeded")
            return x, base + int(iters), A_cur
        except DeviceLost as e:
            if A_cur.num_shards <= 1:
                raise
            survivors = survivor_mesh(A_cur.mesh, int(e.device))
            if dist.get_rank() not in mesh_ranks(survivors):
                raise
            recovered += 1
            _obs_counters.inc("resil.recovery.attempts")
            _obs_counters.inc("resil.recovery.device_loss")
            before = int(A_cur.num_shards)
            A_cur = reshard(A_cur, mesh=survivors, layout=A_cur.layout)
            moved = torch.tensor([_block_bytes(A_cur)], dtype=torch.int64,
                                 device=A_cur.device)
            dist.all_reduce(moved, group=A_cur.vector_group)
            moved = int(moved.item())
            _obs_counters.inc("resil.recovery.mesh_shrink")
            _obs_counters.inc("resil.recovery.reshard_bytes", moved)
            k = _chunk_index(A_cur.mesh, A_cur.layout)
            b_cur = _local_rows(b_glob, A_cur.local_len, k,
                                A_cur.rows_padded)
            snap = ck.restore() if ck is not None else None
            if snap is not None:
                it0, arrays = snap
                # A plain restart from the snapshot's x: r and p are
                # derived afresh (convergence to tolerance is kept, the
                # exact iterate sequence is not).
                x_host = as_tensor(arrays[0], A_cur.device)[:rows].to(
                    b_cur.dtype)
                base += int(it0)
                _obs_counters.inc("resil.recovery.restored_iters", int(it0))
                ck.rebase()
            else:
                x_host = x0_glob
            x0_cur = _local_rows(x_host, A_cur.local_len, k,
                                 A_cur.rows_padded)
            miter = max(int(maxiter) - base, 1)
            _trace.event("resil.recovery", site=site,
                         device=int(e.device), shards_before=before,
                         shards_after=int(A_cur.num_shards),
                         restored_iters=(int(snap[0]) if snap else 0),
                         reshard_bytes=moved)


def _whole(A: DistCSR, v, dtype) -> torch.Tensor:
    """A vector argument (array-like, or a DTensor, gathered) as the
    whole vector of the true row count on this rank's device."""
    return _global_host(v, A.device).to(dtype).reshape(-1)[:A.shape[0]]


def dist_cg(A: DistCSR, b, x0=None, tol=None, maxiter: Optional[int] = None,
            M=None, callback=None, atol: float = 0.0, rtol: float = 1e-5,
            conv_test_iters: int = 25):
    """Distributed (preconditioned) CG (``dist_csr.py:2530``): the
    single-device loop (``linalg._cg_loop``) over this rank's blocks,
    its inner products all-reduced.  ``M`` is a callable on this rank's
    block of a vector, run outside the solve's reductions (a solve
    inside it stays on the rank); ``callback(x)`` sees every iterate as a sharded
    vector.  Returns the solution as a sharded vector of the true row
    count, and the iteration count.

    With ``settings.resil`` (and no callback) the solve is the
    ``dist.cg`` site, runs in ``linalg.cg``'s resilient stretches when a
    deadline, health detection or a checkpoint asks for them, and a
    ``DeviceLost`` takes the recovery ladder (``_solve_with_recovery``):
    the result is then a sharded vector over the survivor mesh, and on
    the lost rank the call raises ``DeviceLost``.  After a shrink ``M``
    is applied to the survivors' blocks, so a preconditioner bound to
    the old partition does not recover."""
    from ..linalg import _cg_loop, _get_atol_rtol, _norm
    from ..linalg import _resil_solver_active

    _obs_counters.handle("op.dist_cg").inc()
    rows, b_loc, x0_loc, maxiter, cb, M_loc = _shard_system(
        A, b, x0, maxiter, callback, M)
    if x0_loc is None:
        x0_loc = torch.zeros_like(b_loc)
    with _reductions(A, "dist_cg"):
        bnrm2 = float(_norm(b_loc))
    atol, _ = _get_atol_rtol(bnrm2, tol, atol, rtol)

    def solve(A_cur, b_cur, x0_cur, miter):
        site = "solver.cg.conv" if (
            cb is None and _resil_solver_active()) else None
        with _reductions(A_cur, "dist_cg"):
            return _cg_loop(A_cur.matvec_fn(), M_loc, b_cur, x0_cur, atol,
                            miter, int(conv_test_iters), cb, site=site,
                            r0_mv=lambda v: _guarded_spmv(A_cur, v))

    with _tctx.profiler_scope("dist_cg"), \
            _lat.timer("lat.dist_cg.solve." + _lat.shape_bucket(rows)), \
            _trace.span("dist_cg", n=rows, shards=A.num_shards,
                        maxiter=maxiter, preconditioned=M is not None) as sp:
        if _settings.resil and cb is None:
            with _maybe_ckpt_scope("dist.cg"):
                x, iters, A_fin = _solve_with_recovery(
                    "dist.cg", A, _whole(A, b, b_loc.dtype),
                    _whole(A, x0 if x0 is not None else torch.zeros(rows),
                           b_loc.dtype), maxiter, solve)
        else:
            x, iters = solve(A, b_loc, x0_loc, maxiter)
            A_fin = A
        if sp is not None:
            sp.set(iters=iters)
    return _global_vector(A_fin, x, rows), iters


def dist_gmres(A: DistCSR, b, x0=None, tol=None, restart=None,
               maxiter=None, M=None, callback=None, atol: float = 0.0,
               callback_type=None, rtol: float = 1e-5):
    """Distributed restarted GMRES (``dist_csr.py:2237``): the
    single-device cycle loop (``linalg._gmres_loop``) over this rank's
    blocks, one host fetch a cycle.  Padding rows are zero rows with a
    zero right-hand side, so the Krylov space keeps them at 0.  With
    ``settings.resil`` a ``DeviceLost`` takes the recovery ladder, which
    re-seeds the Arnoldi process from the last snapshot on the
    survivors (the cycles are the ``solver.gmres.conv`` site)."""
    from ..linalg import (_get_atol_rtol, _gmres_loop, _norm,
                          outside_reductions)

    rows, b_loc, x0_loc, maxiter, cb, M_loc = _shard_system(
        A, b, x0, maxiter, callback, M)
    if callback_type == "pr_norm":
        cb = outside_reductions(callback)
    restart_eff = min(int(restart) if restart else 20, A.rows_padded)
    x = x0_loc if x0_loc is not None else torch.zeros_like(b_loc)
    with _reductions(A, "dist_gmres"):
        bnrm2 = float(_norm(b_loc))
    atol, _ = _get_atol_rtol(bnrm2, tol, atol, rtol)

    def solve(A_cur, b_cur, x0_cur, miter):
        with _reductions(A_cur, "dist_gmres"):
            return _gmres_loop(A_cur.matvec_fn(), M_loc, b_cur, x0_cur,
                               atol, restart_eff, miter, cb,
                               callback_type, bnrm2)

    with _tctx.profiler_scope("dist_gmres"), \
            _trace.span("dist_gmres", n=rows, shards=A.num_shards,
                        restart=restart_eff) as sp:
        if _settings.resil:
            with _maybe_ckpt_scope("dist.gmres"):
                x, iters, A_fin = _solve_with_recovery(
                    "dist.gmres", A, _whole(A, b, b_loc.dtype),
                    _whole(A, x0 if x0 is not None else torch.zeros(rows),
                           b_loc.dtype), maxiter, solve, guard=False)
        else:
            x, iters = solve(A, b_loc, x, maxiter)
            A_fin = A
        if sp is not None:
            sp.set(iters=iters)
    return _global_vector(A_fin, x, rows), iters


def dist_bicgstab(A: DistCSR, b, x0=None, tol=None, maxiter=None, M=None,
                  callback=None, atol: float = 0.0, rtol: float = 1e-5,
                  conv_test_iters: int = 25):
    """Distributed BiCGSTAB (``dist_csr.py:2321``): the single-device
    loop (``linalg._bicgstab_loop``) over this rank's blocks; with a
    callback the convergence test runs every iteration, as in
    ``linalg.bicgstab``."""
    from ..linalg import _bicgstab_loop, _get_atol_rtol, _norm

    rows, b_loc, x0_loc, maxiter, cb, M_loc = _shard_system(
        A, b, x0, maxiter, callback, M)
    x = x0_loc if x0_loc is not None else torch.zeros_like(b_loc)
    with _reductions(A, "dist_bicgstab"):
        atol, _ = _get_atol_rtol(float(_norm(b_loc)), tol, atol, rtol)
        x, iters = _bicgstab_loop(
            A.matvec_fn(), M_loc, b_loc, x, atol, maxiter,
            1 if cb is not None else int(conv_test_iters), cb)
    return _global_vector(A, x, rows), iters


def dist_minres(A: DistCSR, b, x0=None, shift=0.0, tol=None, maxiter=None,
                M=None, callback=None, atol: float = 0.0, rtol: float = 1e-5,
                conv_test_iters: int = 25):
    """Distributed MINRES (``dist_csr.py:2340``): the single-device
    loop (``krylov_extra._minres_loop``) over this rank's blocks; the
    padded rows make the system singular but consistent, which MINRES
    tolerates.  With a ``callback`` the solve is single-device
    ``minres``'s scipy host loop, as in the JAX package, on the padded
    operator (``_host_operator``): every rank runs the same loop on the
    same all-gathered vectors, and the callback sees each iterate as a
    host array of the true row count."""
    from ..krylov_extra import _minres_loop
    from ..linalg import _get_atol_rtol, _norm

    if callback is not None:
        return _minres_on_host(A, b, x0, shift, tol, maxiter, M, callback,
                               rtol)
    rows, b_loc, x0_loc, maxiter, _, M_loc = _shard_system(
        A, b, x0, maxiter, None, M)
    x = x0_loc if x0_loc is not None else torch.zeros_like(b_loc)
    with _reductions(A, "dist_minres"):
        atol, _ = _get_atol_rtol(float(_norm(b_loc)), tol, atol, rtol)
        x, iters = _minres_loop(
            A.matvec_fn(), M_loc, b_loc, x,
            torch.as_tensor(shift, dtype=b_loc.dtype, device=b_loc.device),
            atol, maxiter, int(conv_test_iters))
    return _global_vector(A, x, rows), iters


def _host_operator(A: DistCSR, fn, dtype):
    """``fn`` (this rank's block -> this rank's block) as a scipy
    ``LinearOperator`` on padded host vectors: each rank applies it to
    its block of the vector and the blocks are all-gathered back, so
    every rank returns the same array."""
    import scipy.sparse.linalg as ssl

    L, k, n = A.local_len, _chunk_index(A.mesh, A.layout), A.rows_padded
    dev = A.device

    def mv(v):
        v = torch.from_numpy(np.ascontiguousarray(v).reshape(-1)).to(
            dev, dtype)
        y = _all_gather(fn(v[k * L:(k + 1) * L]), A.vector_group)
        return to_numpy(y)

    return ssl.LinearOperator((n, n), matvec=mv,
                              dtype=np.dtype(str(dtype).split(".")[-1]))


def _minres_on_host(A: DistCSR, b, x0, shift, tol, maxiter, M, callback,
                    rtol):
    """``dist_minres(callback=...)``: single-device ``minres`` (its
    scipy branch) on the padded system, as the JAX package runs it."""
    from ..krylov_extra import minres

    rows, n, dev = A.shape[0], A.rows_padded, A.device
    bt = _local_rows(_global_host(b, dev), n, 0, n)
    x0t = (None if x0 is None else
           _local_rows(_global_host(x0, dev).to(bt.dtype), n, 0, n))
    op = _host_operator(A, A.matvec_fn(), bt.dtype)
    Mop = None if M is None else _host_operator(A, M, bt.dtype)
    x, iters = minres(op, bt, x0=x0t, shift=shift, tol=tol,
                      maxiter=rows * 10 if maxiter is None else maxiter,
                      M=Mop, callback=lambda xk: callback(xk[:rows]),
                      rtol=rtol)
    x = _local_rows(x, A.local_len, _chunk_index(A.mesh, A.layout), n)
    return _global_vector(A, x, rows), iters


def dist_eigsh(A: DistCSR, k=6, which="LM", v0=None, ncv=None,
               maxiter=None, tol=0, return_eigenvectors=True, sigma=None):
    """Distributed symmetric eigensolver (``dist_csr.py:2367``): the
    single-device Lanczos (``eigen._lanczos_eigsh``) over this rank's
    blocks.  The start vector and the breakdown restarts are zero on
    padding rows (``mask``) and the Krylov dimension is capped at the
    true row count, so no spurious zero eigenvalue appears.  ``sigma``
    (and ``which='SM'``, served as sigma = 0) runs the single-device
    shift-invert driver, its inner MINRES over the ranks; a stagnating
    probe raises ``ArpackNoConvergence`` (no host fallback for a
    distributed operator).  Returns the eigenvalues (and the
    eigenvectors as a sharded (rows, k) block)."""
    from ..eigen import (_eigsh_shift_invert, _lanczos_eigsh,
                         _require_real_sigma, _validate_be_k)

    rows = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    if not (0 < k < rows):
        raise ValueError(f"k={k} must satisfy 0 < k < n={rows}")
    if which not in ("LM", "LA", "SA", "BE", "SM"):
        raise ValueError(f"which={which!r}: distributed eigsh supports "
                         f"LM/LA/SA/BE/SM")
    _validate_be_k(which, k)
    if which == "SM" and sigma is None:
        sigma, which = 0.0, "LM"    # the largest of A^{-1}
    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(rows)
    L = A.local_len
    kk = _chunk_index(A.mesh, A.layout)
    v0_loc = _local_rows(_global_host(v0, A.device).to(A.dtype), L, kk,
                         A.rows_padded)
    mask = _local_rows(torch.ones((rows,), dtype=A.dtype, device=A.device),
                       L, kk, A.rows_padded)
    with _reductions(A, "dist_eigsh"):
        if sigma is None:
            out = _lanczos_eigsh(A.matvec_fn(), L, A.dtype, A.device, int(k),
                                 which, v0_loc, ncv, maxiter, tol,
                                 return_eigenvectors, max_rank=rows,
                                 mask=mask)
        else:
            _require_real_sigma(sigma)
            out = _eigsh_shift_invert(
                A.matvec_fn(), A.rows_padded, A.dtype, A.device, int(k),
                float(sigma), which, v0_loc, ncv, maxiter, tol,
                return_eigenvectors, name="dist_eigsh", mask=mask,
                max_rank=rows)
    if not return_eigenvectors:
        return out
    w, X = out
    return w, _global_vector(A, X, rows)
