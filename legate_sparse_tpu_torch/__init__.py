# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""legate_sparse_tpu_torch: the PyTorch/CUDA port of legate_sparse_tpu.

A scipy.sparse-shaped sparse package on PyTorch tensors for an NVIDIA
H100 (``import legate_sparse_tpu_torch as sparse``).  It holds the
main path ``diags(...)`` → ``dia_array.tocsr`` → ``csr_array.dot``
(banded SpMV through the CUDA kernel ``csrc/dia_spmv.cu``, irregular
SpMV through ``csrc/bsr_spmv.cu``) → the solvers of ``linalg`` (``cg``,
``gmres``, ``bicgstab``, ``minres``, ``lsqr``, ``lsmr``,
``differentiable_solve``, the ``jacobi``/``block_jacobi``
preconditioners, ``expm_multiply``, ``norm``); SpMM
(``csrc/dia_spmm.cu``, ``csrc/bsr_spmm.cu``); SpGEMM (banded through
``csrc/dia_spgemm.cu``, general by expand-sort-compress); the apps
``apps.pde`` and ``apps.gmg`` (multigrid-preconditioned CG); the scipy
facade on which operators are built: the ``csr``, ``csc``, ``coo`` and
``dia`` formats (arrays and ``*_matrix`` flavours) with their
arithmetic, comparisons, reductions, indexing and conversions, the
gallery's constructors (``eye``, ``kron``, ``tril``, ``vstack``,
``bmat``, ...) and its seeded generators (``random``, ``powerlaw``,
``rmat``); Matrix Market and npz io; the eigensolvers ``eigs``,
``eigsh``, ``lobpcg`` and ``svds`` (Lanczos and Arnoldi over the SpMV
kernels, LOBPCG over the SpMM kernels); ``csgraph`` (components,
Laplacians, shortest paths, spanning trees); and the rest of
scipy.sparse's namespace, through scipy on the host
(``coverage.clone_module``).

Entry points run on ``cuda`` unless the caller names a device
(``device="cpu"``, or ``runtime.set_device("cpu")``); with no CUDA
device and no such request they raise.  The package imports neither
``jax`` nor ``legate_sparse_tpu``.  The eigensolvers (``linalg.eigs``,
``eigsh``, ``lobpcg``, ``svds``) and ``csgraph`` are the port's own,
on the operator's or graph's device.  ``graph`` (BFS, SSSP, connected
components and PageRank as semiring SpMV over the distribution layer)
and ``delta`` (streaming mutation: ``DeltaCSR``, ``DistDeltaCSR``) are
the graph-analytics and mutation layers.  The serving path is
``engine`` (shape-bucketed plans, the micro-batching executor and the
multi-tenant gateway: ``engine.get_gateway().submit(A, x, tenant=,
qos=)``), ``autotune`` (measured kernel verdicts) and ``resilience``
(fault injection, retries, breakers, deadlines); each is off until its
setting turns it on.
"""

import scipy.sparse as _scipy_sparse

from . import runtime  # noqa: F401
from .module import *  # noqa: F401,F403  (module.__all__)
from .types import SparseEfficiencyWarning  # noqa: F401
from .base import CompressedBase  # noqa: F401
from .coverage import clone_module as _clone_module
from . import linalg  # noqa: F401
from . import graph  # noqa: F401
from . import autotune, engine, resilience  # noqa: F401

# Every other scipy.sparse name as its scipy fallback, so the namespace
# is complete (reference ``__init__.py:36``).
_clone_module(_scipy_sparse, globals())

# scipy's csgraph module object came in with the clone; the port's own
# takes its place (reference ``__init__.py:41-49``).  While the name is
# bound, ``from . import csgraph`` would hand back scipy's module.
globals().pop("csgraph", None)
from . import csgraph  # noqa: E402,F401

del _scipy_sparse, _clone_module
