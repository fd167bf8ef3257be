# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The distribution layer on ``torch.distributed``: process groups and
meshes, row/column/2-d block sharded CSR, distributed SpMV/SpMM/SpGEMM,
the distributed solvers, the distributed GMG preconditioner,
resharding and the sharded banded constructors.

Counterpart of ``legate_sparse_tpu/parallel/`` (its ``mesh``,
``dist_csr``, ``dist_build``, ``dist_spgemm``, ``dist_gmg`` and
``reshard``), under the same public names.  Every
rank is a process that calls the same functions with the same
arguments, holds one shard on its own device, and talks to the others
through NCCL (``cuda``) or gloo (the CPU)::

    from legate_sparse_tpu_torch import parallel as P
    P.init_distributed()                 # NCCL; backend="gloo" on CPUs
    mesh = P.make_row_mesh()
    A = P.dist_poisson2d(1024, mesh=mesh, dtype="float32")
    x, iters = P.dist_cg(A, b, rtol=1e-5)   # x: a sharded DTensor

``launch.run_ranks`` starts N ranks of a fresh group from a process
that holds none.  ``survivor_mesh`` is the mesh without a lost rank,
onto which the solvers' recovery ladder ``reshard``s.
"""

from .mesh import (  # noqa: F401
    LAYOUT_1D_COL,
    LAYOUT_1D_ROW,
    LAYOUT_2D_BLOCK,
    LAYOUT_AUTO,
    LAYOUTS,
    factor_grid,
    init_distributed,
    make_grid_mesh,
    make_row_mesh,
    resolve_layout,
    row_spec,
    survivor_mesh,
)
from .dist_csr import (  # noqa: F401
    DistCSR,
    shard_csr,
    shard_dense,
    dist_spmv,
    dist_spmm,
    dist_cg,
    dist_gmres,
    dist_bicgstab,
    dist_minres,
    dist_eigsh,
    dist_diagonal,
    dist_plan_fingerprint,
    mesh_fingerprint,
)
from .dist_build import dist_diags, dist_poisson2d  # noqa: F401
from .dist_spgemm import dist_spgemm  # noqa: F401
from .dist_gmg import DistGMG  # noqa: F401
from .reshard import chunk_permute_plan, reshard, reshard_vector  # noqa: F401
