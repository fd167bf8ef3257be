# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Communication ledger: predicted interconnect bytes for a
distributed layer's collectives, computed from STATIC shard shapes.

The port's copy of ``legate_sparse_tpu/obs/comm.py``, verbatim in its
arithmetic: the distribution layer (ROADMAP queue 1 item 8) records
through it, and its tests assert the ``comm.*`` counters equal these
static predictions.  The numbers derive from the shard shapes and
dtypes a distributed dispatch closes over, so they are exact
predictions of what its collectives move, not timings, and they cost a
handful of integer multiplies per dispatch.

Accounting convention
---------------------
Bytes are the TOTAL crossing the interconnect, summed over all mesh
devices, counting each transferred element once at its receiver:

- ``all_gather`` of an L-element local block over R shards: every
  device receives the other R-1 blocks  ->  R*(R-1)*L*itemsize.
- halo exchange (two ``ppermute`` rounds of an H-element boundary
  slice): every device receives one slice per direction
  ->  2*R*H*itemsize.
- ``psum`` of an L-element value: ring all-reduce (reduce-scatter +
  all-gather) moves 2*(R-1)*L elements  ->  2*(R-1)*L*itemsize.
- ``all_to_all`` of an (R, C)-row send buffer: each device keeps its
  own row and sends R-1  ->  R*(R-1)*C*itemsize.
- one ``ppermute`` rotation round of an L-element block: every device
  receives the block once  ->  R*L*itemsize.

An R == 1 mesh moves nothing (every formula counts remote receivers,
of which there are none), so a 1-device "distributed" run correctly
ledgers zero interconnect bytes — and ``record`` drops zero-byte
entries rather than emitting noise counters.

Counters (always on, per-thread buffered — ``counters.handle`` — so a
hot eager loop of distributed dispatches never contends on the module
lock)::

    comm.<op>.<collective>          collective ops at <op> dispatch
    comm.<op>.<collective>_bytes    predicted interconnect bytes
    comm.total_calls / comm.total_bytes

In the JAX package an op traced inside a jitted solver loop records
once per trace, and its solver entry points record per-iteration
volumes times the iteration count; eager PyTorch records every
dispatch that runs.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import attrib as _attrib
from . import counters as _counters

Volumes = Dict[str, int]     # collective kind -> predicted bytes


# ---------------------------------------------------------------- model --
def all_gather_bytes(local_elems: int, itemsize: int, shards: int) -> int:
    """Interconnect bytes of one tiled all_gather of an
    ``local_elems``-element per-device block."""
    if shards <= 1:
        return 0
    return shards * (shards - 1) * int(local_elems) * int(itemsize)


def ppermute_bytes(block_elems: int, itemsize: int, shards: int,
                   rounds: int = 1) -> int:
    """Interconnect bytes of ``rounds`` ring-rotation ppermutes of a
    ``block_elems``-element per-device block (every device receives
    the block once per round)."""
    if shards <= 1:
        return 0
    return int(rounds) * shards * int(block_elems) * int(itemsize)


def halo_exchange_bytes(halo_elems: int, itemsize: int,
                        shards: int) -> int:
    """Interconnect bytes of one two-sided halo exchange (the
    ``_extend_x`` pattern): one ``halo_elems`` boundary slice ppermuted
    in each ring direction."""
    if shards <= 1 or halo_elems <= 0:
        return 0
    return 2 * shards * int(halo_elems) * int(itemsize)


def psum_bytes(elems: int, itemsize: int, shards: int) -> int:
    """Interconnect bytes of one psum (ring all-reduce) of an
    ``elems``-element value."""
    if shards <= 1:
        return 0
    return 2 * (shards - 1) * int(elems) * int(itemsize)


def all_to_all_bytes(row_elems: int, itemsize: int, shards: int) -> int:
    """Interconnect bytes of one tiled all_to_all of an (R, row_elems)
    per-device send buffer (own row stays local)."""
    if shards <= 1:
        return 0
    return shards * (shards - 1) * int(row_elems) * int(itemsize)


def reduce_scatter_bytes(input_elems: int, itemsize: int,
                         shards: int) -> int:
    """Interconnect bytes of one tiled ``psum_scatter`` (ring
    reduce-scatter) of an ``input_elems``-element per-device input over
    ``shards`` devices: each device receives (R-1) partial chunks of
    L/R elements, so the group total is (R-1)*L."""
    if shards <= 1:
        return 0
    return (shards - 1) * int(input_elems) * int(itemsize)


def lowered_op_bytes(kind: str, operand_bytes: int, *,
                     group_sizes=(), moved_pairs: int = 0) -> int:
    """Interconnect bytes of ONE lowered collective op, from its IR
    attributes, under the same total-at-receivers convention as the
    model formulas above (the JAX package cross-checks its lowered
    programs' operand shapes against the ledger with it):

    - ``collective_permute``: ``moved_pairs`` non-identity
      source-target pairs each deliver the per-device operand once
      (matches both the halo rounds — R pairs — and the 2-d chunk
      transpose, whose identity pairs move nothing);
    - ``all_gather``: each replica group of size g has every member
      receive the other g-1 operand blocks  ->  sum g*(g-1)*operand;
    - ``all_reduce`` (psum): ring all-reduce per group  ->
      sum 2*(g-1)*operand;
    - ``reduce_scatter``: each member receives g-1 partial chunks of
      operand/g  ->  sum (g-1)*operand;
    - ``all_to_all``: the operand IS the (g, row) send buffer; own row
      stays local  ->  sum (g-1)*operand.

    ``operand_bytes`` is the per-device operand size read from the IR
    tensor type; ``group_sizes`` the replica-group sizes."""
    ob = int(operand_bytes)
    if kind == "collective_permute":
        return int(moved_pairs) * ob
    per_group = {
        "all_gather": lambda g: g * (g - 1) * ob,
        "all_reduce": lambda g: 2 * (g - 1) * ob,
        "reduce_scatter": lambda g: (g - 1) * ob,
        "all_to_all": lambda g: (g - 1) * ob,
    }
    if kind not in per_group:
        raise KeyError(f"unknown lowered collective kind {kind!r}")
    return sum(per_group[kind](int(g)) for g in group_sizes)


def transpose_moved_chunks(grid_rows: int, grid_cols: int) -> int:
    """Number of vector chunks the 2-d-block input fixup ``ppermute``
    actually moves: chunk k's destination under the row-major ->
    column-panel transpose is (k % R) * C + k // R; fixed points
    (including the whole permutation when R == 1 or C == 1) cost
    nothing."""
    n = grid_rows * grid_cols
    return sum(
        1 for k in range(n)
        if (k % grid_rows) * grid_cols + k // grid_rows != k
    )


# --------------------------------------------------------------- ledger --
def merge(*vols: Volumes) -> Volumes:
    """Sum per-collective volumes across several dicts."""
    out: Volumes = {}
    for v in vols:
        for k, b in v.items():
            out[k] = out.get(k, 0) + int(b)
    return out


def scale(vols: Volumes, k: int) -> Volumes:
    """Volumes for ``k`` repetitions (e.g. per-iteration x iters)."""
    return {name: int(b) * int(k) for name, b in vols.items()}


def total(vols: Volumes) -> int:
    return sum(int(b) for b in vols.values())


def record(op: str, vols: Volumes,
           calls: Optional[Dict[str, int]] = None,
           layout: str = "1d-row") -> int:
    """Account one dispatch of ``op``: bump the ``comm.<op>.*``
    counters per collective kind and the process totals.  ``calls``
    optionally gives the collective-op count per kind (default 1 —
    pass the rotation/iteration counts for chained patterns).
    Zero-byte entries are dropped (nothing crossed the interconnect).
    ``layout`` additionally groups the dispatch under the
    ``comm.layout.<layout>.<op>[_bytes]`` aggregates (per-op totals
    over collective kinds — NOT double-counted into
    ``comm.total_*``), so the ledger can be sliced by partition
    strategy.  Returns the total
    predicted bytes."""
    total_b = 0
    total_c = 0
    for kind, nbytes in vols.items():
        nbytes = int(nbytes)
        if nbytes <= 0:
            continue
        n_calls = int(calls.get(kind, 1)) if calls else 1
        _counters.handle(f"comm.{op}.{kind}").inc(n_calls)
        _counters.handle(f"comm.{op}.{kind}_bytes").inc(nbytes)
        total_b += nbytes
        total_c += n_calls
    if total_c:
        _counters.handle("comm.total_calls").inc(total_c)
        _counters.handle("comm.total_bytes").inc(total_b)
        _counters.handle(f"comm.layout.{layout}.{op}").inc(total_c)
        _counters.handle(f"comm.layout.{layout}.{op}_bytes").inc(total_b)
        # Same gating as comm.total_bytes, so the per-tenant attributed
        # sums conserve against it exactly (obs/attrib.py).
        _attrib.on_comm(op, total_b, total_c)
    return total_b


# ------------------------------------------------- structure predictors --
def spmv_volumes(*, shards: int, halo: int, precise_C: Optional[int],
                 x_local_elems: int, itemsize: int,
                 cols: int = 1) -> Volumes:
    """Per-call collective volumes of one distributed SpMV/SpMM x
    realization, mirroring the ``dist_spmv`` dispatch exactly:

    - precise image plan (``precise_C`` = plan width C): one tiled
      all_to_all of (R, C[, cols]) send rows;
    - halo mode (``halo`` >= 0): one two-sided halo exchange of
      ``halo``[* cols] elements (zero when halo == 0 — ``_extend_x``
      returns early and no collective exists in the program);
    - otherwise: one tiled all_gather of the ``x_local_elems``-element
      local x block (``x_local_elems`` already includes ``cols`` for
      SpMM operands).

    ``cols`` is the per-device dense-operand column count for the SpMM
    variants (halo slices and all_to_all rows widen by it).
    """
    if precise_C is not None:
        return {"all_to_all": all_to_all_bytes(
            precise_C * cols, itemsize, shards)}
    if halo >= 0:
        b = halo_exchange_bytes(halo * cols, itemsize, shards)
        return {"ppermute": b} if b else {}
    return {"all_gather": all_gather_bytes(x_local_elems, itemsize,
                                           shards)}


def spmv_volumes_2d(*, grid_rows: int, grid_cols: int, spc: int,
                    rps: int, itemsize: int) -> Volumes:
    """Per-call collective volumes of one 2-d-block distributed SpMV,
    mirroring the ``_block_spmv_2d_fn`` dispatch exactly:

    - input fixup: one ``ppermute`` over the flattened grid moving the
      vector chunks (``spc`` elements each) that the row-major ->
      column-panel transpose displaces — absent (zero bytes, no op in
      the program) on degenerate 1-D grids;
    - x panel assembly: one tiled ``all_gather`` along mesh rows in
      each of the ``grid_cols`` column groups (group size
      ``grid_rows``);
    - output reduction: one tiled ``psum_scatter`` along mesh columns
      in each of the ``grid_rows`` row groups, of the
      ``rps``-element partial row block — recorded under the ``psum``
      kind (it IS the reduce half of an all-reduce).
    """
    moved = transpose_moved_chunks(grid_rows, grid_cols)
    vols = {
        "ppermute": moved * int(spc) * int(itemsize),
        "all_gather": grid_cols * all_gather_bytes(spc, itemsize,
                                                  grid_rows),
        "psum": grid_rows * reduce_scatter_bytes(rps, itemsize,
                                                 grid_cols),
    }
    return {k: b for k, b in vols.items() if b > 0}


def spmv_volumes_2d_semiring(*, grid_rows: int, grid_cols: int,
                             spc: int, rps: int, x_itemsize: int,
                             y_itemsize: int,
                             collective: str) -> Volumes:
    """Per-call collective volumes of one 2-d-block SEMIRING dist
    SpMV, mirroring ``_block_semiring_spmv_2d_fn`` exactly: the input
    fixup ``ppermute`` and x panel ``all_gather`` are the plus-times
    program verbatim (``spmv_volumes_2d``), but ``psum_scatter`` only
    exists for sum — the output reduction is the semiring's add
    ALL-reduce (pmin/pmax/por) of the full ``rps``-element partial
    row block along mesh columns, ring cost 2*(g-1)*rps per row group
    (twice the reduce-scatter half), recorded under the semiring
    ``collective`` kind.  x and y itemsizes differ for ``or-and``
    (bool frontier in, bool out) and mixed-precision operands."""
    moved = transpose_moved_chunks(grid_rows, grid_cols)
    vols = {
        "ppermute": moved * int(spc) * int(x_itemsize),
        "all_gather": grid_cols * all_gather_bytes(spc, x_itemsize,
                                                   grid_rows),
        collective: grid_rows * psum_bytes(rps, y_itemsize, grid_cols),
    }
    return {k: b for k, b in vols.items() if b > 0}


def cg_iteration_volumes(spmv_vols: Volumes, itemsize: int,
                         shards: int) -> Volumes:
    """One iteration of the fused CG while_loop body: the SpMV
    realization plus THREE scalar reductions — rho = <r, z>,
    pq = <p, q>, and rnorm2 = <r, r>.  The residual-norm vdot is
    computed unconditionally every iteration (``conv_test_iters``
    only gates the *decision* made from it, not the reduction), so it
    is part of the per-iteration volume, not a periodic extra.  The
    initial-residual SpMV (r0 = b - A x0) is the caller's +1."""
    return merge(spmv_vols, {"psum": 3 * psum_bytes(1, itemsize, shards)})


def reshard_volumes(*, moved_chunks: int, chunk_elems: int,
                    itemsize: int, shards: int) -> Volumes:
    """One cached chunk-permute reshard program
    (``parallel/reshard.py``): a single ``ppermute`` over the flat
    device order moving ``moved_chunks`` per-device chunks of
    ``chunk_elems`` elements each — chunks whose source and
    destination device coincide are identity pairs and move nothing
    (the same fixed-point discount as ``transpose_moved_chunks``).
    Zero volumes (single shard, or an identity placement) mean the
    lowered program contains no collective at all."""
    if shards <= 1 or moved_chunks <= 0:
        return {}
    b = int(moved_chunks) * int(chunk_elems) * int(itemsize)
    return {"ppermute": b} if b else {}


def gmres_cycle_volumes(spmv_vols: Volumes, restart: int, itemsize: int,
                        shards: int) -> Volumes:
    """One sync-free GMRES restart cycle: ``restart + 1`` SpMV
    realizations (the initial residual plus one per Arnoldi step) and
    the cycle's scalar reductions — ``j + 1`` MGS projections at step
    j plus the column norm, plus the entry residual norm:
    ``restart*(restart+1)/2 + restart + 1`` scalar psums."""
    n_psum = restart * (restart + 1) // 2 + restart + 1
    return merge(scale(spmv_vols, restart + 1),
                 {"psum": n_psum * psum_bytes(1, itemsize, shards)})
