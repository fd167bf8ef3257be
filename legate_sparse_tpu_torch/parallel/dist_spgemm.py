# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Distributed SpGEMM, C = A @ B, on ``torch.distributed``.

Counterpart of ``legate_sparse_tpu/parallel/dist_spgemm.py``: the banded
product (``_dist_band_spgemm``/``_band_spgemm_fn``, ``:590-690``), the
1-d ESC product (``dist_spgemm``, ``:1048``; ``_dist_spgemm_impl``,
``:1073``) with its B realization by window or all-gather
(``_b_window_plan``, ``:289``; ``_b_window_flat``, ``:399``;
``_b_realization_volumes``, ``:693``) and the 2-d SUMMA product
(``_dist_spgemm_2d``, ``:918``; ``_summa_volumes_2d``, ``:891``).

- **Banded**: exactly-banded square operands in halo mode multiply
  their row-indexed DIA blocks, B's rows extended by the halo exchange
  (``dist_csr._extend_x``), in the JAX loop's order (``for a_i`` outer,
  ``for b_i`` inner), so the result is bit for bit the JAX package's.
  Plain PyTorch, as the JAX product is ``jnp``.
- **1-d ESC**: each rank computes its row block of C with the
  single-device ESC (``ops/spgemm.py::spgemm_csr_csr_csr_impl``) on its
  rows of A against B's realized rows: the B row blocks its A columns
  reach, brought by ring rotations (``batch_isend_irecv``), or all of
  B all-gathered when that window is too wide.  The JAX package plans
  the window from host arrays of the whole A; here every rank holds
  only its own, so one all-gather of each rank's (min, max) column
  (and its B block's nnz) gives every rank the same plan.
- **2-d SUMMA**: block (i, j) gathers its A row panel over the
  mesh-column group and its B column panel over the mesh-row group and
  runs the same ESC; C is a 2-d-block ``DistCSR`` on the same grid.

The JAX package pads every rank's block of C to the largest, learnt
by host syncs of the product count and nnz (``:1209``, ``:1233``).
Eager PyTorch needs no common size: each rank keeps its own nnz, and
one all-gather of the per-rank counts gives every rank ``nnz_hint``
and ``nnz_cap`` (the JAX package's padded width, which its comm
formulas and plan keys read).

``comm.dist_spgemm.*`` and ``comm.dist_spgemm.window_probe.*`` count
what the port sends (``_Wire``: every all-gather and ring rotation of
the product, group totals as ``obs.comm`` counts them).  The JAX
package's prediction of its own three padded phases
(``_b_realization_volumes``, ``_summa_volumes_2d``) is the
``dist_spgemm.realization`` event's ``predicted_*`` bytes, as there.
With ``settings.resil`` the whole multiply is the ``dist.spgemm``
fault/retry site (``:1063-1070``): a sequence of collective phases with
host syncs between them, retried from its immutable operands, bit for
bit on success.  ``obs.memory`` has no ``watermark`` here, so the
phase's memory event is not emitted.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..obs import comm as _comm
from ..obs import counters as _obs_counters
from ..obs import latency as _lat
from ..obs import trace as _trace
from ..types import coord_dtype_for
from .dist_csr import (
    DistCSR, _all_gather, _extend_x, _local_entries, _ring,
    attach_dia_prepack, mesh_fingerprint,
)
from .mesh import COL_AXIS, ROW_AXIS


class _Wire:
    """The collectives a product sends, as ``obs.comm`` counts them:
    bytes moved over the whole group and one call per collective,
    added up as they are sent; the same on every rank."""

    def __init__(self):
        self.vols, self.calls = {}, {}

    def add(self, kind: str, nbytes: int, calls: int = 1) -> None:
        if nbytes > 0:
            self.vols[kind] = self.vols.get(kind, 0) + int(nbytes)
            self.calls[kind] = self.calls.get(kind, 0) + int(calls)


def _entry_bytes(*parts) -> int:
    """Bytes of one entry carried as the tensors ``parts``."""
    return sum(p.element_size() for p in parts)


def _block_sizes(n: int, group, dev, wire: _Wire) -> list:
    """Every rank's count ``n`` over ``group``, in group order: one
    all-gather of an int64."""
    wire.add("all_gather", _comm.all_gather_bytes(
        1, 8, dist.get_world_size(group)))
    return _all_gather(torch.tensor([n], dtype=torch.int64, device=dev),
                       group).cpu().tolist()


class _Layout(NamedTuple):
    """What the plan and the comm formulas read of an operand
    (``dist_spgemm.py:59``); every field is the same on every rank."""

    ell: bool
    rps: int
    halo: int
    cps: int
    has_ggl: bool
    shape: Tuple[int, int]
    rows_padded: int
    num_shards: int
    inner: int          # W for ELL blocks, the padded width for CSR


def _layout_of(M: DistCSR) -> _Layout:
    inner = int(M.cols.shape[-1]) if M.ell else (
        M.nnz_cap or int(M.cols.shape[-1]))
    return _Layout(
        ell=M.ell, rps=M.rows_per_shard, halo=M.halo,
        cps=M.cols_per_shard, has_ggl=M.gather_globals is not None,
        shape=M.shape, rows_padded=M.rows_padded,
        num_shards=M.num_shards, inner=inner)


# A window wider than this fraction of the ring takes the all-gather.
_B_WINDOW_DENSE_FRAC = 0.75

# How the last general product realized B ("window" | "all_gather")
# and the plan it took; read them through ``last_b_realization()``.
LAST_B_REALIZATION: str = ""
LAST_B_PLAN: tuple = ()
_WINDOW_DECLINED: set = set()
_STATE_LOCK = threading.Lock()


def _density_bucket(nnz: int, rows: int) -> int:
    """log2 bucket of nnz per row: the sparsity term of the decline
    key (``dist_spgemm.py:252``)."""
    if nnz <= 0 or rows <= 0:
        return -1
    per_row = nnz / rows
    return int(np.floor(np.log2(per_row))) if per_row >= 1 else -1


def _decline_key(A: DistCSR, la: _Layout, lb: _Layout):
    """The decline cache's key (``dist_spgemm.py:266``): both layouts,
    A's density bucket and its mesh and layout fingerprint; the density
    bucket stays at ``key[2]``."""
    return (la, lb, _density_bucket(A.nnz_hint, la.shape[0]),
            mesh_fingerprint(A.mesh, layout=A.layout))


def _window_decline(key, la: _Layout, lb: _Layout) -> None:
    with _STATE_LOCK:
        if len(_WINDOW_DECLINED) > 256:
            _WINDOW_DECLINED.clear()
        _WINDOW_DECLINED.add(key)
    _obs_counters.inc("dist_spgemm.window_decline")
    _trace.event("dist_spgemm.window_decline", a_shape=la.shape,
                 b_shape=lb.shape, shards=la.num_shards,
                 density_bucket=key[2])


def last_b_realization() -> tuple:
    """``(LAST_B_REALIZATION, LAST_B_PLAN)`` read together under the
    state lock (``dist_spgemm.py:378``)."""
    with _STATE_LOCK:
        return LAST_B_REALIZATION, LAST_B_PLAN


def reset_window_declines() -> None:
    """Clear the window-decline cache (``dist_spgemm.py:389``)."""
    with _STATE_LOCK:
        _WINDOW_DECLINED.clear()


def _b_window_plan(A: DistCSR, la: _Layout, lb: _Layout, a_cols, b_nnz):
    """The window plan (``dist_spgemm.py:289``), the same on every rank:
    ``(first_blks, (nblk, d_fwd, d_bwd), nnz_blks)`` or None for the
    all-gather.  One all-gather of each rank's (min, max) global column
    of A and the nnz of its block of B agrees on it (the probe);
    ``nnz_blks`` is every rank's B block nnz, which the rotations
    need.  None without a probe where B has a precise layout, at two
    ranks or fewer, or where the key already declined."""
    if lb.has_ggl:
        return None
    R = la.num_shards
    if R <= 2:
        return None
    key = _decline_key(A, la, lb)
    with _STATE_LOCK:
        declined = key in _WINDOW_DECLINED
    if declined:
        _obs_counters.inc("dist_spgemm.window_decline_cached")
        return None
    _obs_counters.inc("transfer.host_sync.spgemm_window_probe")
    # One gather of three int64s a rank (the JAX package's two gathers
    # of the min and the max).
    _comm.record("dist_spgemm.window_probe", {
        "all_gather": _comm.all_gather_bytes(3, 8, R)})
    dev = a_cols.device
    big = la.shape[1]
    if a_cols.numel():
        mine = torch.stack([a_cols.min(), a_cols.max(),
                            torch.tensor(b_nnz, device=dev)])
    else:
        mine = torch.tensor([big, -1, b_nnz], dtype=torch.int64, device=dev)
    probe = _all_gather(mine.to(torch.int64).reshape(1, 3),
                        A.mesh.get_group(ROW_AXIS)).cpu().numpy()
    mn, mx, nnz_blks = probe[:, 0], probe[:, 1], probe[:, 2]
    rps_b = lb.rps
    first = np.clip(mn // rps_b, 0, R - 1).astype(np.int64)
    last = np.clip(mx // rps_b, 0, R - 1).astype(np.int64)
    s_ids = np.arange(R)
    empty = mx < 0
    first[empty] = s_ids[empty]
    last[empty] = s_ids[empty]
    nblk = int(np.max(last - first) + 1)
    # A floor of 3 keeps a 2-block window (a band crossing one block
    # boundary) on small rings.
    limit = max(3, int(R * _B_WINDOW_DENSE_FRAC))
    if nblk <= 0 or nblk >= limit:
        _window_decline(key, la, lb)
        return None
    d_fwd = int(np.max(np.maximum(s_ids - first, 0)))
    d_bwd = int(np.max(np.maximum(last - s_ids, 0)))
    if d_fwd + d_bwd >= R:
        _window_decline(key, la, lb)
        return None
    return first.astype(np.int32), (nblk, d_fwd, d_bwd), nnz_blks


def _b_realization_volumes(B: DistCSR, lb: _Layout, plan):
    """The JAX package's prediction of B's realization over its three
    padded phases, for both candidates (``dist_spgemm.py:693``):
    ``(ag_vols, win_vols)``, ``win_vols`` None without an accepted
    plan."""
    R = lb.num_shards
    item_d = B.data.element_size()
    item_c = B.cols.element_size()
    if lb.ell:
        data_b = lb.rps * lb.inner * item_d
        cols_b = lb.rps * lb.inner * item_c
        cnt_b = lb.rps * 4
        rid_b = 0
    else:
        data_b = lb.inner * item_d
        cols_b = lb.inner * item_c
        cnt_b = 4
        rid_b = lb.inner * 4
    ggl_b = 0
    if lb.has_ggl:
        g = B.gather_globals
        ggl_b = int(g.shape[0]) * int(g.shape[1]) * g.element_size()
    phase1_b = cnt_b + rid_b
    phase23_b = data_b + cols_b + cnt_b + rid_b + ggl_b
    ag_vols = {"all_gather": _comm.all_gather_bytes(
        phase1_b + 2 * phase23_b, 1, R)}
    win_vols = None
    if plan is not None:
        _, d_fwd, d_bwd = plan
        w_phase23_b = data_b + cols_b + cnt_b + rid_b
        win_vols = {"ppermute": _comm.ppermute_bytes(
            phase1_b + 2 * w_phase23_b, 1, R, rounds=d_fwd + d_bwd)}
    return ag_vols, win_vols


# ------------------------------------------------------ B's realization --

def _csr_rows(rows, cols, vals, n_rows: int):
    """(indptr, cols, vals) of entries already sorted by row."""
    counts = torch.bincount(rows, minlength=n_rows)
    indptr = torch.zeros((n_rows + 1,), dtype=torch.int64,
                         device=rows.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, cols, vals


def _gather_entries(rows, cols, vals, group, sizes):
    """Every rank's entries over ``group``, in group order: ``(src,
    rows, cols, vals)`` with ``src`` each entry's source rank in the
    group.  ``sizes`` is every rank's entry count in group order;
    blocks of unequal size travel padded to the largest (three
    all-gathers, none where every block is empty)."""
    dev = rows.device
    cap = max(sizes)
    if cap == 0:
        empty = rows.new_zeros((0,))
        return empty, empty, cols.new_zeros((0,)), vals.new_zeros((0,))

    def pad(t):
        return torch.cat([t, t.new_zeros((cap - t.shape[0],))])

    n = torch.tensor(sizes, dtype=torch.int64, device=dev)
    keep = (torch.arange(cap, device=dev)[None, :]
            < n[:, None]).reshape(-1)
    src = torch.arange(len(sizes), device=dev).repeat_interleave(cap)[keep]
    return (src, _all_gather(pad(rows), group)[keep],
            _all_gather(pad(cols), group)[keep],
            _all_gather(pad(vals), group)[keep])


def _b_all_gather(B: DistCSR, rows, cols, vals, wire: _Wire):
    """B's realized rows by the all-gather: every row block, rows
    global (``_b_global_flat``, ``dist_spgemm.py:130``)."""
    group = B.mesh.get_group(ROW_AXIS)
    R = dist.get_world_size(group)
    sizes = _block_sizes(int(rows.shape[0]), group, rows.device, wire)
    wire.add("all_gather", _comm.all_gather_bytes(
        max(sizes), _entry_bytes(rows, cols, vals), R), calls=3)
    src, r, c, v = _gather_entries(rows, cols, vals, group, sizes)
    return _csr_rows(src * B.rows_per_shard + r, c, v, B.rows_padded), 0


def _rotate(parts, dst: int, src: int, n_in: int, group):
    """Send ``parts`` (one block's rows, cols, vals) to ``dst`` and
    receive the ``n_in`` entries of the block ``src`` holds; empty
    blocks travel as no message (every rank knows every size)."""
    out = tuple(p.new_empty((n_in,)) for p in parts)
    ops = []
    if parts[0].shape[0]:
        ops += [dist.P2POp(dist.isend, p.contiguous(), dst, group, tag)
                for tag, p in enumerate(parts)]
    if n_in:
        ops += [dist.P2POp(dist.irecv, o, src, group, tag)
                for tag, o in enumerate(out)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _b_window(B: DistCSR, first_blks, plan, nnz_blks, rows, cols, vals,
              wire: _Wire):
    """B's realized rows by the window (``_b_window_flat``,
    ``dist_spgemm.py:399``): ``d_fwd`` rotations forward and ``d_bwd``
    backward around the ring, each rank keeping the blocks inside its
    window ``[first, first + nblk)``.  Rows are window-relative; the
    second value is the window's first global row.  Each rotation moves
    every block one step: all of B's entries."""
    nblk, d_fwd, d_bwd = plan
    group = B.mesh.get_group(ROW_AXIS)
    R, left, right = _ring(group)
    wire.add("ppermute", (d_fwd + d_bwd) * int(np.sum(nnz_blks))
             * _entry_bytes(rows, cols, vals), calls=d_fwd + d_bwd)
    s = B.shard
    rps = B.rows_per_shard
    first = int(first_blks[s])
    held = {s: (rows, cols, vals)}
    for step, dst, src, sign in ((d_fwd, right, left, -1),
                                 (d_bwd, left, right, 1)):
        cur = (rows, cols, vals)
        for d in range(1, step + 1):
            blk = (s + sign * d) % R
            cur = _rotate(cur, dst, src, int(nnz_blks[blk]), group)
            held[blk] = cur
    parts = [(t, held[t]) for t in range(first, min(first + nblk, R))
             if t in held]
    r = torch.cat([(t - first) * rps + p[0] for t, p in parts])
    c = torch.cat([p[1] for t, p in parts])
    v = torch.cat([p[2] for t, p in parts])
    return _csr_rows(r, c, v, nblk * rps), first * rps


# ------------------------------------------------------------ products --

def _esc_block(a_rows, a_cols, a_vals, m: int, b_csr, k: int, n: int,
               dtype):
    """This rank's block of C by the single-device ESC: ``(data, cols,
    row_ids)`` of the (m, n) product of A's entries (sorted by row)
    against B's realized rows."""
    from ..ops.convert import row_ids_from_indptr
    from ..ops.spgemm import spgemm_csr_csr_csr_impl

    a_indptr, _, _ = _csr_rows(a_rows, a_cols, a_vals, m)
    b_indptr, b_cols, b_vals = b_csr
    data, idx, indptr, _ = spgemm_csr_csr_csr_impl(
        a_vals.to(dtype), a_cols, a_indptr, b_vals.to(dtype), b_cols,
        b_indptr, m, k, max(n, 1))
    return data, idx, row_ids_from_indptr(indptr.to(torch.int64),
                                          data.shape[0])


def _agreed_nnz(ln: int, group, dev, wire: _Wire) -> Tuple[int, int]:
    """``(sum, max)`` of every rank's nnz over ``group``: one
    all-gather (``transfer.host_sync.dist_spgemm_nnz``)."""
    _obs_counters.inc("transfer.host_sync.dist_spgemm_nnz")
    n = _block_sizes(ln, group, dev, wire)
    return sum(n), max(n)


def _padded_block(data, cols, row_ids, rps: int, col_dtype, dev):
    """(data, cols, row_ids, counts) of a padded-CSR block holding this
    rank's entries (one slot at least)."""
    ln = int(data.shape[0])
    if ln == 0:
        return (data.new_zeros((1,)),
                torch.zeros((1,), dtype=col_dtype, device=dev),
                torch.full((1,), max(rps - 1, 0), dtype=torch.int32,
                           device=dev),
                torch.tensor(0, dtype=torch.int32, device=dev))
    return (data.contiguous(), cols.to(col_dtype).contiguous(),
            row_ids.to(torch.int32).contiguous(),
            torch.tensor(ln, dtype=torch.int32, device=dev))


def _dist_band_spgemm(A: DistCSR, B: DistCSR):
    """C = A @ B for exactly-banded square operands
    (``dist_spgemm.py:590-690``): ``nd_a * nd_b`` shifted multiply-adds
    of the row-indexed DIA blocks, B's rows extended by the halo
    exchange; a DIA-layout ``DistCSR`` with its ELL blocks
    (``band_ell_local``) and kernel pack, or None where the
    preconditions fail."""
    from ..ops.dia_ops import (
        band_cover, band_product_is_full, band_product_offsets,
    )
    from ..settings import settings
    from .dist_build import band_ell_local

    if (A.dia_data is None or B.dia_data is None
            or A.dia_mask is not None or B.dia_mask is not None
            or A.shape[0] != A.shape[1] or B.shape[0] != B.shape[1]
            or A.rows_per_shard != B.rows_per_shard):
        return None
    n = A.shape[0]
    rps = A.rows_per_shard
    offs_a, offs_b = A.dia_offsets, B.dia_offsets
    offs_c = band_product_offsets(offs_a, offs_b)
    nnz_c = band_cover(offs_c, (n, n), n)
    h = max(abs(o) for o in offs_a)          # B-row reach of the product
    halo_c = max(abs(o) for o in offs_c)     # halo of the result
    if (h > rps or halo_c > rps
            or len(offs_c) > settings.dia_max_diags
            or len(offs_c) * n > settings.dia_max_expand * max(nnz_c, 1)
            or not band_product_is_full(offs_a, offs_b, offs_c, A.shape,
                                        B.shape)):
        return None
    a, b = A.dia_data, B.dia_data
    dev = a.device
    # B's rows (dim 1) extended from the ring neighbours; the wrapped
    # values at the global edges meet A's zeros there.
    b_ext = _extend_x(b.T.contiguous(), h,
                      A.mesh.get_group(ROW_AXIS)).T
    idx_c = {o: i for i, o in enumerate(offs_c)}
    C = torch.zeros((len(offs_c), rps),
                    dtype=torch.promote_types(a.dtype, b.dtype), device=dev)
    for a_i, oa in enumerate(offs_a):
        for b_i, ob in enumerate(offs_b):
            C[idx_c[oa + ob]] += a[a_i] * b_ext[b_i, h + oa:h + oa + rps]
    start = A.shard * rps
    r_l = torch.arange(rps, dtype=torch.int64, device=dev)
    ell_data, ell_cols, cnt = band_ell_local(
        C, torch.tensor(offs_c, dtype=torch.int64, device=dev), n, rps,
        halo_c, start, start + r_l, r_l)
    return attach_dia_prepack(DistCSR(
        data=ell_data, cols=ell_cols, counts=cnt, row_ids=None,
        shape=(n, n), rows_per_shard=rps, halo=halo_c, ell=True,
        mesh=A.mesh, dia_data=C, dia_offsets=tuple(offs_c),
        nnz_hint=nnz_c))


def _summa_volumes_2d(A: DistCSR, B: DistCSR, grid):
    """The JAX package's prediction of its three 2-d phases
    (``dist_spgemm.py:891``): A row panels gathered along mesh columns,
    B column panels along mesh rows (``bcast``)."""
    Rr, Rc = grid
    capA = A.nnz_cap or int(A.data.shape[-1])
    capB = B.nnz_cap or int(B.data.shape[-1])
    ia_d, ia_c = A.data.element_size(), A.cols.element_size()
    ib_d, ib_c = B.data.element_size(), B.cols.element_size()
    a1 = Rr * _comm.all_gather_bytes(capA * ia_c + 4, 1, Rc)
    a23 = Rr * _comm.all_gather_bytes(capA * (ia_d + ia_c + 4) + 4, 1, Rc)
    b1 = Rc * _comm.all_gather_bytes(capB * 4 + 4, 1, Rr)
    b23 = Rc * _comm.all_gather_bytes(capB * (ib_d + ib_c + 4) + 4, 1, Rr)
    return {"all_gather": a1 + 2 * a23, "bcast": b1 + 2 * b23}


def _block_entries(M: DistCSR):
    """(rows, cols, vals) of this rank's 2-d block, block-local."""
    ln = int(M.counts)
    return (M.row_ids[:ln].to(torch.int64), M.cols[:ln].to(torch.int64),
            M.data[:ln])


def _dist_spgemm_2d(A: DistCSR, B: DistCSR) -> DistCSR:
    """C = A @ B for 2-d-block operands on one grid
    (``dist_spgemm.py:918``): block (i, j) of C is A's row panel i
    (gathered along the mesh columns, columns rebased by each source's
    column offset) times B's column panel j (gathered along the mesh
    rows, rows rebased by each source's row offset), by the same ESC.
    C's columns stay block-local: it takes B's column blocking.  One
    all-gather of every block's two entry counts over the mesh tells
    every rank the panels' sizes."""
    mesh = A.mesh
    Rr, Rc = A.grid
    N = Rr * Rc
    rps, rps_b = A.rows_per_shard, B.rows_per_shard
    cps_a, cps_b = A.cols_per_shard, B.cols_per_shard
    m, n_cols = A.shape[0], B.shape[1]
    dev = A.data.device
    _obs_counters.inc("dist_spgemm.realization.2d_panel")
    vols = _summa_volumes_2d(A, B, A.grid)
    inner1 = max(-(-B.nnz_hint // N), 1)
    ag1d = _comm.all_gather_bytes(
        (4 + inner1 * 4) + 2 * (inner1 * (B.data.element_size()
                                          + B.cols.element_size() + 4) + 4),
        1, N)
    _trace.event("dist_spgemm.realization", choice="2d-panel", shards=N,
                 grid=A.grid, predicted_bytes=_comm.total(vols),
                 predicted_all_gather_bytes=ag1d,
                 predicted_window_bytes=None)
    val_dtype = torch.promote_types(A.dtype, B.dtype)
    wire = _Wire()
    with _lat.timer("lat.dist_spgemm." + _lat.shape_bucket(m)), \
            _trace.span("dist_spgemm", shards=N, m=m, n=n_cols,
                        b_realization="2d-panel", b_plan=()) as sp:
        ea, eb = _block_entries(A), _block_entries(B)
        world = dist.group.WORLD
        sizes = np.asarray(_all_gather(torch.tensor(
            [[ea[0].shape[0], eb[0].shape[0]]], dtype=torch.int64,
            device=dev), world).cpu().numpy())
        wire.add("all_gather", _comm.all_gather_bytes(2, 8, N))
        # Block (i, j) is rank mesh.mesh[i, j]: A's panels run along the
        # mesh rows, B's along the mesh columns, each padded to its own
        # largest block.
        grid_ranks = mesh.mesh.cpu().numpy()
        wire.add("all_gather", sum(_comm.all_gather_bytes(
            int(sizes[grid_ranks[i], 0].max()), _entry_bytes(*ea), Rc)
            for i in range(Rr)), calls=3)
        wire.add("all_gather", sum(_comm.all_gather_bytes(
            int(sizes[grid_ranks[:, j], 1].max()), _entry_bytes(*eb), Rr)
            for j in range(Rc)), calls=3)

        def group_sizes(group, col):
            return [int(sizes[r, col])
                    for r in dist.get_process_group_ranks(group)]

        g = mesh.get_group(COL_AXIS)
        k, r, c, v = _gather_entries(*ea, g, group_sizes(g, 0))
        order = torch.argsort(r, stable=True)
        a_rows, a_cols, a_vals = r[order], (c + k * cps_a)[order], v[order]
        g = mesh.get_group(ROW_AXIS)
        t, r, c, v = _gather_entries(*eb, g, group_sizes(g, 1))
        b_csr = _csr_rows(t * rps_b + r, c, v, Rr * rps_b)
        data, cols, rids = _esc_block(a_rows, a_cols, a_vals, rps, b_csr,
                                      Rr * rps_b, cps_b, val_dtype)
        nnz, cap = _agreed_nnz(int(data.shape[0]), world, dev, wire)
        comm_bytes = _comm.record("dist_spgemm", wire.vols, wire.calls,
                                  layout=A.layout)
        if sp is not None:
            sp.set(nnz_cap=max(cap, 1), nnz=nnz, comm_bytes=comm_bytes,
                   comm_calls=sum(wire.calls.values()))
    data, cols, rids, counts = _padded_block(
        data, cols, rids, rps, coord_dtype_for(n_cols), dev)
    return DistCSR(
        data=data, cols=cols, counts=counts, row_ids=rids,
        shape=(m, n_cols), rows_per_shard=rps, halo=-1, ell=False,
        mesh=mesh, cols_per_shard=cps_b, nnz_hint=nnz, layout=A.layout,
        grid=A.grid, nnz_cap=max(cap, 1))


def dist_spgemm(A: DistCSR, B: DistCSR) -> DistCSR:
    """C = A @ B over the ranks (``dist_spgemm.py:1048``); every rank
    calls it with its blocks of the same two operands.

    Exactly-banded square operands take the banded product (a DIA
    result in halo mode, consumable by the DIA kernel's distributed
    SpMV); 2-d-block operands on one grid take SUMMA (a 2-d-block
    result); everything else the 1-d ESC (a padded-CSR row-block result
    with global columns).  With ``settings.resil`` the call is the
    ``dist.spgemm`` site."""
    from ..resilience import guarded_call
    from ..settings import settings

    if settings.resil:
        return guarded_call("dist.spgemm", lambda: _dist_spgemm(A, B))
    return _dist_spgemm(A, B)


def _dist_spgemm(A: DistCSR, B: DistCSR) -> DistCSR:
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"dimension mismatch: {A.shape} @ {B.shape}")
    if A.mesh is not B.mesh and A.mesh != B.mesh:
        raise ValueError("operands must share a mesh")
    _obs_counters.inc("op.dist_spgemm")
    if A.grid is not None or B.grid is not None:
        if A.grid is None or B.grid is None or A.grid != B.grid:
            raise ValueError(
                f"dist_spgemm: operands must share one 2-d grid "
                f"(got {A.grid} and {B.grid}); reshard with the same "
                f"layout")
        return _dist_spgemm_2d(A, B)

    with _trace.span("dist_spgemm.band_probe"):
        C_band = _dist_band_spgemm(A, B)
    if C_band is not None:
        _obs_counters.inc("dist_spgemm.realization.band")
        h = max(abs(int(o)) for o in A.dia_offsets)
        band_vols = {"ppermute": _comm.halo_exchange_bytes(
            len(B.dia_offsets) * h, B.dia_data.element_size(),
            A.num_shards)}
        band_bytes = _comm.record("dist_spgemm", band_vols,
                                  layout=A.layout)
        _trace.event("dist_spgemm.realization", choice="band",
                     shards=A.num_shards, predicted_bytes=band_bytes)
        return C_band
    A._require_blocks("dist_spgemm")
    B._require_blocks("dist_spgemm")
    return _dist_spgemm_1d(A, B)


def _dist_spgemm_1d(A: DistCSR, B: DistCSR) -> DistCSR:
    """The 1-d ESC product (``_dist_spgemm_impl``, ``:1073-1266``)."""
    global LAST_B_REALIZATION, LAST_B_PLAN

    rps = A.rows_per_shard
    m, n_cols = A.shape[0], B.shape[1]
    R = A.num_shards
    dev = A.data.device
    la, lb = _layout_of(A), _layout_of(B)
    a_rows, a_cols, a_vals = _local_entries(A)
    a_cols = torch.clamp(a_cols, 0, max(A.shape[1] - 1, 0))
    b_rows, b_cols, b_vals = _local_entries(B)
    b_cols = torch.clamp(b_cols, 0, max(n_cols - 1, 0))
    win = _b_window_plan(A, la, lb, a_cols, int(b_rows.shape[0]))
    plan = None if win is None else win[1]
    realization = "all_gather" if win is None else "window"
    b_plan = (() if win is None
              else (tuple(int(f) for f in win[0]), *win[1]))
    with _STATE_LOCK:
        LAST_B_REALIZATION, LAST_B_PLAN = realization, b_plan
    _obs_counters.inc("dist_spgemm.realization." + realization)
    ag_vols, win_vols = _b_realization_volumes(B, lb, plan)
    _trace.event(
        "dist_spgemm.realization", choice=realization, shards=R,
        predicted_bytes=_comm.total(ag_vols if win is None else win_vols),
        predicted_all_gather_bytes=_comm.total(ag_vols),
        predicted_window_bytes=(_comm.total(win_vols)
                                if win_vols is not None else None))
    val_dtype = torch.promote_types(A.dtype, B.dtype)
    wire = _Wire()
    with _lat.timer("lat.dist_spgemm." + _lat.shape_bucket(m)), \
            _trace.span("dist_spgemm", shards=R, m=m, n=n_cols,
                        b_realization=realization, b_plan=b_plan) as sp:
        if win is None:
            b_csr, row_base = _b_all_gather(B, b_rows, b_cols, b_vals,
                                            wire)
        else:
            b_csr, row_base = _b_window(B, win[0], plan, win[2], b_rows,
                                        b_cols, b_vals, wire)
        k = b_csr[0].shape[0] - 1
        data, cols, rids = _esc_block(a_rows, a_cols - row_base, a_vals,
                                      rps, b_csr, k, n_cols, val_dtype)
        nnz, cap = _agreed_nnz(int(data.shape[0]),
                               A.mesh.get_group(ROW_AXIS), dev, wire)
        comm_bytes = _comm.record("dist_spgemm", wire.vols, wire.calls,
                                  layout=A.layout)
        if sp is not None:
            sp.set(nnz_cap=max(cap, 1), nnz=nnz, comm_bytes=comm_bytes,
                   comm_calls=sum(wire.calls.values()))
    data, cols, rids, counts = _padded_block(
        data, cols, rids, rps, coord_dtype_for(n_cols), dev)
    return DistCSR(
        data=data, cols=cols, counts=counts, row_ids=rids,
        shape=(m, n_cols), rows_per_shard=rps, halo=-1, ell=False,
        mesh=A.mesh, nnz_hint=nnz, nnz_cap=max(cap, 1))
