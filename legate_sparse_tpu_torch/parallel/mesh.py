# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Process groups and device meshes of the distribution layer.

Counterpart of ``legate_sparse_tpu/parallel/mesh.py`` (``:1-203``) on
``torch.distributed``.  The JAX package's mesh is a grid of devices
driven by one controller; here every rank is a process that holds one
device, and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks: 1-D ``("rows",)`` from ``make_row_mesh``, 2-D
``("rows", "cols")`` from ``make_grid_mesh``.  A mesh the constructors
build covers every rank of the job (each rank is one shard; there is no
idle rank), so the default process group is the whole mesh's group.

A sharded vector is a ``DTensor``: ``row_sharding(mesh)`` (``Shard(0)``
over "rows", replicated over "cols") for the 1d-row layout.  The
``row_spec``/``row_sharding``/``replicated`` placements take the place
of the JAX package's ``PartitionSpec``/``NamedSharding``.

``survivor_mesh`` (the recovery ladder's mesh shrink,
``mesh.py:131-160``) is the one mesh over fewer ranks: the source
mesh's ranks in its flat order less the lost ones.  A shard's index is
its rank's position in its mesh (``mesh_position``), which on a mesh
over every rank is the rank itself.  Creating a mesh or a process
group is a collective of the whole job, so every rank calls
``survivor_mesh``, the lost one too, and it builds there every group
the survivors use afterwards (a grid's flat mesh and its (1, n) grid).
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

ROW_AXIS = "rows"
COL_AXIS = "cols"

# Partition layouts of ``shard_csr`` (the JAX package's names): row
# blocks over the mesh's "rows" axis; the (1, N) degenerate grid; a
# (rows, cols) block grid; or routed by predicted interconnect bytes.
LAYOUT_1D_ROW = "1d-row"
LAYOUT_1D_COL = "1d-col"
LAYOUT_2D_BLOCK = "2d-block"
LAYOUT_AUTO = "auto"
LAYOUTS = (LAYOUT_1D_ROW, LAYOUT_1D_COL, LAYOUT_2D_BLOCK, LAYOUT_AUTO)


def resolve_layout(layout: Optional[str] = None) -> str:
    """The layout asked for: the argument, else ``settings.dist_layout``
    (``LEGATE_SPARSE_TPU_DIST_LAYOUT``), else ``"1d-row"``.  ``"auto"``
    stays ``"auto"``: ``shard_csr`` routes it."""
    if layout is None:
        from ..settings import settings

        layout = settings.dist_layout or LAYOUT_1D_ROW
    if layout not in LAYOUTS:
        raise ValueError(
            f"unknown dist layout {layout!r}; expected one of {LAYOUTS}")
    return layout


def factor_grid(n: int) -> Tuple[int, int]:
    """Near-square ``(r, c)`` with ``r * c == n``, ``r <= c`` and ``r``
    as large as possible."""
    r = int(n ** 0.5)
    while r > 1 and n % r:
        r -= 1
    return max(r, 1), n // max(r, 1)


def default_backend() -> str:
    """NCCL when the port's default device is ``cuda``, gloo when the
    caller asked for the CPU (``runtime.set_device("cpu")``).  With no
    CUDA device and no such request it raises, as every entry point of
    the port does."""
    from ..runtime import default_device

    return "nccl" if default_device().type == "cuda" else "gloo"


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[float] = None) -> None:
    """Join the job's process group (``torch.distributed
    .init_process_group``): NCCL when the ranks run on ``cuda``, gloo
    when the caller asks for the CPU (``backend="gloo"``, or
    ``runtime.set_device("cpu")``).  With no CUDA device and no such
    request it raises, as every entry point of the port does.

    ``init_method``, ``world_size`` and ``rank`` go to
    ``init_process_group`` as they are (None: its ``env://`` defaults);
    ``timeout`` is in seconds.  A NCCL rank takes the card
    ``rank % device_count``.  A second call is a no-op."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = default_backend()
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: the NCCL backend needs a "
                               "CUDA device; pass backend='gloo' for the CPU")
        if rank is not None:
            torch.cuda.set_device(rank % torch.cuda.device_count())
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank, **kwargs)


def device_type() -> str:
    """``"cuda"`` for a NCCL job, ``"cpu"`` for gloo."""
    if not dist.is_initialized():
        raise RuntimeError("legate_sparse_tpu_torch.parallel: call "
                           "init_distributed() first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _all_ranks(devices, name: str) -> int:
    """The world size, after checking that ``devices`` (None, a count or
    a sequence of ranks) names every rank in order."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if devices is None:
        if not world:
            device_type()          # raises: no process group yet
        return world
    ranks = (list(range(devices)) if isinstance(devices, int)
             else [int(r) for r in devices])
    if ranks != list(range(world)):
        raise ValueError(
            f"{name}: a mesh covers every rank of the job in order "
            f"(world size {world}); got {devices!r}")
    return world


_JOB = {"group": None, "cache": {}}


def job_cache() -> dict:
    """A dict for what belongs to the job's process group (its meshes,
    the ring neighbours of ``dist_csr``): emptied when another default
    group has replaced the one it was filled under (a
    ``destroy_process_group`` and a second ``init_distributed``)."""
    group = dist.GroupMember.WORLD
    if group is not _JOB["group"]:
        _JOB["group"], _JOB["cache"] = group, {}
    return _JOB["cache"]


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          ranks: Optional[Sequence[int]] = None):
    """One ``DeviceMesh`` per shape, rank list (default ``0..n-1``) and
    job (creating one creates its process groups, a collective every
    rank of the job must join)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    ranks = tuple(range(n)) if ranks is None else tuple(int(r)
                                                        for r in ranks)
    key = ("mesh", device_type(), tuple(shape), names, ranks)
    cache = job_cache()
    if key not in cache:
        cache[key] = DeviceMesh(key[1], torch.tensor(ranks).reshape(shape),
                                mesh_dim_names=names)
    return cache[key]


def mesh_ranks(mesh) -> list:
    """The global ranks of ``mesh`` in its flat (row-major) order."""
    return [int(r) for r in mesh.mesh.reshape(-1).tolist()]


def mesh_position(mesh) -> int:
    """This rank's position in ``mesh``'s flat order: the shard index of
    the 2-d layouts and of a vector's chunk (the rank itself on a mesh
    over every rank)."""
    ranks = mesh_ranks(mesh)
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not a member of the mesh over "
                         f"ranks {ranks}")
    return ranks.index(me)


def make_row_mesh(devices: Optional[Union[int, Sequence[int]]] = None):
    """1-D ``("rows",)`` mesh over every rank (``devices``: None, the
    world size, or the ranks ``0..world-1``)."""
    n = _all_ranks(devices, "make_row_mesh")
    return _mesh((n,), (ROW_AXIS,))


def make_grid_mesh(devices: Optional[Union[int, Sequence[int]]] = None,
                   shape: Optional[Union[Tuple[int, int], int]] = None):
    """2-D ``("rows", "cols")`` mesh over every rank; ``shape`` defaults
    to ``factor_grid`` of the rank count.  ``make_grid_mesh(R, C)`` (two
    ints) is an (R, C) grid."""
    if isinstance(devices, int) and isinstance(shape, int):
        devices, shape = devices * shape, (devices, shape)
    n = _all_ranks(devices, "make_grid_mesh")
    r, c = factor_grid(n) if shape is None else shape
    if r * c != n:
        raise ValueError(f"grid shape {(r, c)} != rank count {n}")
    return _mesh((int(r), int(c)), (ROW_AXIS, COL_AXIS))


def flat_mesh(mesh=None):
    """The 1-D mesh over ``mesh``'s ranks in its flat order (default:
    every rank in order): the mesh of the 2-d layouts' vectors, whose
    chunk ``k`` lives on the mesh's ``k``-th rank."""
    ranks = (list(range(dist.get_world_size())) if mesh is None
             else mesh_ranks(mesh))
    return _mesh((len(ranks),), ("flat",), ranks)


def survivor_mesh(mesh, lost: Union[int, Sequence[int]]):
    """The shrunken mesh after losing the rank(s) at flat ordinal(s)
    ``lost`` of ``mesh``: the recovery ladder's mesh-shrink step
    (``mesh.py:131-160``).

    Survivors keep the source mesh's flat order less the lost ordinals,
    so row blocks stay contiguous.  A 1-D mesh shrinks to a 1-D mesh of
    the same axis name; a 2-D (rows, cols) grid re-factors the survivor
    count through ``factor_grid``.  Raises rather than return an empty
    mesh when every rank is lost.

    A collective of the whole job: every rank calls it with the same
    arguments, the lost ones too (their coordinate in the result is
    None), and it creates every group the survivors need afterwards:
    for a grid, also its flat mesh and the (1, n) grid over the
    survivors (a 1d-col matrix's)."""
    flat = mesh_ranks(mesh)
    lost_set = ({int(lost)} if isinstance(lost, int)
                else {int(i) for i in lost})
    bad = sorted(i for i in lost_set if not 0 <= i < len(flat))
    if bad:
        raise ValueError(
            f"survivor_mesh: lost ordinal(s) {bad} outside flat mesh of "
            f"{len(flat)} ranks")
    survivors = [r for i, r in enumerate(flat) if i not in lost_set]
    if not survivors:
        raise ValueError("survivor_mesh: no ranks survive")
    names = tuple(mesh.mesh_dim_names)
    if mesh.ndim == 1:
        out = _mesh((len(survivors),), names, survivors)
    else:
        out = _mesh(factor_grid(len(survivors)), names, survivors)
        flat_mesh(out)
        _mesh((1, len(survivors)), names, survivors)
    cache = job_cache()
    cache.setdefault("survivors", set()).add(id(out))
    return out


def is_survivor_mesh(mesh) -> bool:
    """True for a mesh ``survivor_mesh`` made in this job."""
    return id(mesh) in job_cache().get("survivors", ())


def row_spec():
    """The placements of a row-sharded vector on a 1-D mesh."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def row_sharding(mesh):
    """Row blocks over "rows", replicated over any other mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)


def replicated(mesh):
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim
