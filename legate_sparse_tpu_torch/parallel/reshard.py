# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Resharding: distributed operands onto another mesh or layout.

Counterpart of ``legate_sparse_tpu/parallel/reshard.py``:
``chunk_permute_plan`` (``:71``), the chunk permute
(``_chunk_permute_program``, ``:103``), ``reshard_vector`` (``:127``)
and ``reshard`` (``:188``), which hands a ``delta.DistDeltaCSR`` to its
``_delta_reshard_carry`` (``:204-209``).

- ``reshard_vector``: a sharded padded vector is one contiguous chunk
  per rank, in the mesh's flat order.  A placement change over the same
  ranks sends chunk ``c`` from the rank that holds it under the source
  mesh to the rank that holds it under the destination mesh: one
  ``batch_isend_irecv`` round over the ranks, a local copy where the two
  are one rank.  Priced by ``obs.comm.reshard_volumes``; an identity
  placement moves and records nothing.  The JAX package compiles and
  caches one ``shard_map`` per mesh pair; eager P2P has nothing to
  cache.
- ``reshard``: block layouts differ (halo-rebased ELL windows, 2-d
  panels with block-local columns), so a layout or mesh change re-runs
  ``shard_csr`` on the ``csr_array`` it kept (``DistCSR._src_csr``).  A
  destination with the source's ``mesh_fingerprint(mesh, layout)``
  returns ``A`` itself.

A destination over fewer ranks is the recovery ladder's shrink: onto a
``mesh.survivor_mesh`` (the survivors in the source's order), where
every surviving rank still holds the source matrix, so the survivors
rebuild the lost rank's rows too (only the survivors call it).  Any
other mesh over fewer ranks raises a typed ``ValueError`` naming both
fingerprints.  The port's matrices live on rank-ordered meshes (their ring
and gather collectives follow the group's rank order); a mesh whose
flat order permutes the ranks is a placement for vectors only, and
there a chunk is read with ``to_local()`` (a ``DeviceMesh`` builds its
groups in sorted rank order, so DTensor's own collectives and
``get_local_rank`` do not follow the permutation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..obs import comm as _comm
from ..obs import counters as _obs_counters
from ..obs import trace as _trace
from .dist_csr import _dtensor, mesh_fingerprint, shard_csr
from .mesh import (
    LAYOUT_1D_COL, LAYOUT_1D_ROW, LAYOUT_2D_BLOCK, flat_mesh,
    is_survivor_mesh, make_grid_mesh, make_row_mesh, mesh_ranks,
    resolve_layout,
)

__all__ = ["reshard", "reshard_vector", "chunk_permute_plan"]


def chunk_permute_plan(src_mesh, dst_mesh) -> Tuple[Tuple[Tuple[int, int],
                                                        ...], int]:
    """The permute's pairs and how many move a chunk
    (``reshard.py:71``): chunk ``c`` lives on flat rank ``src[c]`` and
    must end on ``dst[c]``, flat ordinal ``src.index(dst[c])`` of the
    source, so the pair is ``(c, src.index(dst[c]))``; identity pairs
    are kept and move nothing."""
    src, dst = mesh_ranks(src_mesh), mesh_ranks(dst_mesh)
    if len(src) != len(dst) or set(src) != set(dst):
        raise ValueError(
            "chunk_permute_plan: src and dst meshes must cover the "
            "same device set (a shrink/grow is a repartition — use "
            "reshard / shard_vector from host state)")
    pairs = tuple((c, src.index(dst[c])) for c in range(len(src)))
    return pairs, sum(1 for s, t in pairs if s != t)


def _vector_target(mesh):
    """The 1-D mesh a vector takes on ``mesh``: the mesh itself, or for
    a 2-d grid the flat mesh of every rank (chunk ``k`` on rank ``k``,
    the grid's row-major order)."""
    return mesh if mesh.ndim == 1 else flat_mesh(mesh)


def reshard_vector(x, mesh, layout: str = LAYOUT_1D_ROW):
    """``x`` (a ``DTensor`` sharded along dim 0 over a 1-D mesh) moved
    onto ``mesh``'s placement by one chunk permute (``reshard.py:127``):
    the same global vector, chunk ``c`` now on the rank that holds chunk
    ``c`` under ``mesh`` (a 2-d grid: the flat mesh over its ranks)."""
    from torch.distributed.tensor import Shard

    src_mesh = x.device_mesh
    if src_mesh.ndim != 1 or tuple(x.placements) != (Shard(0),):
        raise ValueError(
            "reshard_vector: expected a vector sharded along dim 0 over a "
            f"1-D mesh; got placements {tuple(x.placements)} on a "
            f"{src_mesh.ndim}-D mesh")
    dst_mesh = _vector_target(mesh)
    G, G_dst = src_mesh.size(), dst_mesh.size()
    L = int(x.shape[0])
    if G_dst != G:
        raise ValueError(
            f"reshard_vector: device count changed ({G} -> {G_dst}; src "
            f"mesh {mesh_fingerprint(src_mesh)} -> dst mesh "
            f"{mesh_fingerprint(dst_mesh)}); a mesh shrink/grow is a "
            "repartition — re-shard from host state (shard_vector / "
            "checkpoint restore)")
    if L % G:
        raise ValueError(
            f"reshard_vector: length {L} not divisible by {G} chunks")
    pairs, moved = chunk_permute_plan(src_mesh, dst_mesh)
    vols = _comm.reshard_volumes(moved_chunks=moved, chunk_elems=L // G,
                                 itemsize=x.dtype.itemsize, shards=G)
    comm_bytes = _comm.record("dist_reshard", vols, calls={"ppermute": 1},
                              layout=layout)
    src, dst = mesh_ranks(src_mesh), mesh_ranks(dst_mesh)
    me = dist.get_rank()
    chunk = x.to_local()
    with _trace.span("dist_reshard", shards=G, moved=moved,
                     comm_bytes=comm_bytes):
        send_to = dst[src.index(me)]        # where my chunk must end
        recv_from = src[dst.index(me)]      # who holds the chunk I own
        if send_to == me:
            out = chunk.clone()
        else:
            out = torch.empty_like(chunk)
            ops = [dist.P2POp(dist.isend, chunk.contiguous(), send_to),
                   dist.P2POp(dist.irecv, out, recv_from)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return _dtensor(out, dst_mesh, (Shard(0),), tuple(x.shape))


def _default_mesh(layout: str):
    """The destination mesh over every rank when the caller names only
    a layout (``reshard.py:177``)."""
    if layout == LAYOUT_2D_BLOCK:
        return make_grid_mesh()
    if layout == LAYOUT_1D_COL:
        return make_grid_mesh(shape=(1, dist.get_world_size()))
    return make_row_mesh()


def reshard(A, mesh=None, layout: Optional[str] = None):
    """``A`` repartitioned onto ``mesh``/``layout``, each defaulting to
    the source's layout and a mesh over every rank (``reshard.py:188``):
    ``A`` itself where the destination's ``mesh_fingerprint(mesh,
    layout)`` is the source's, else ``shard_csr`` of the ``csr_array``
    ``A`` kept.  A destination over fewer ranks must be a
    ``survivor_mesh`` (the recovery ladder's shrink; only its ranks call
    this).  A matrix without a kept source (not built by ``shard_csr``),
    another destination over fewer ranks, or one whose order permutes
    the ranks raises ``ValueError``.  A ``delta.DistDeltaCSR`` carries its
    pending updates across (``_delta_reshard_carry``, ``reshard.py:204``)."""
    carry = getattr(A, "_delta_reshard_carry", None)
    if carry is not None:
        return carry(mesh, layout)
    lay = A.layout if layout is None else resolve_layout(layout)
    dst_mesh = _default_mesh(lay) if mesh is None else mesh
    _obs_counters.inc("op.reshard")
    src_fp = mesh_fingerprint(A.mesh, A.layout)
    dst_fp = mesh_fingerprint(dst_mesh, lay)
    if dst_fp == src_fp:
        _trace.event("reshard.matrix", moved=False, layout=lay,
                     shards=A.num_shards)
        return A
    world = dist.get_world_size()
    shrink = dst_mesh.size() != world
    if shrink and not is_survivor_mesh(dst_mesh):
        raise ValueError(
            f"reshard: the destination mesh covers {dst_mesh.size()} of "
            f"{world} ranks (src mesh {mesh_fingerprint(A.mesh)} -> dst "
            f"mesh {mesh_fingerprint(dst_mesh)}) and is no survivor mesh; "
            "a mesh over fewer ranks comes from parallel.survivor_mesh")
    ranks = mesh_ranks(dst_mesh)
    if ranks != (sorted(ranks) if shrink else list(range(world))):
        raise ValueError(
            f"reshard: the destination mesh {mesh_fingerprint(dst_mesh)} "
            "permutes the ranks; "
            "matrices live on rank-ordered meshes (reshard_vector moves "
            "vectors onto such a placement)")
    src = A._src_csr
    if src is None:
        raise ValueError(
            "reshard: this DistCSR carries no retained source matrix "
            "(_src_csr); shard_csr retains one — rebuild via "
            "shard_csr, or repartition your own source explicitly")
    with _trace.span("dist_reshard_matrix", layout=lay,
                     shards=dst_mesh.size()):
        B = shard_csr(src, mesh=dst_mesh, layout=lay)
    _trace.event("reshard.matrix", moved=True, layout=lay,
                 src_layout=A.layout, shards=B.num_shards)
    return B
