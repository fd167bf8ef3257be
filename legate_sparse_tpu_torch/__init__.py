# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""legate_sparse_tpu_torch: the PyTorch/CUDA port of legate_sparse_tpu.

A scipy.sparse-shaped sparse package on PyTorch tensors for an NVIDIA
H100 (``import legate_sparse_tpu_torch as sparse``).  It holds the
main path ``diags(...)`` → ``dia_array.tocsr`` → ``csr_array.dot``
(banded SpMV through the CUDA kernel ``csrc/dia_spmv.cu``, irregular
SpMV through ``csrc/bsr_spmv.cu``) → ``linalg.cg``; SpMM
(``csrc/dia_spmm.cu``, ``csrc/bsr_spmm.cu``); SpGEMM (banded through
``csrc/dia_spgemm.cu``, general by expand-sort-compress); the apps
``apps.pde`` and ``apps.gmg`` (multigrid-preconditioned CG); and the
scipy facade on which operators are built: the ``csr``, ``csc``,
``coo`` and ``dia`` formats (arrays and ``*_matrix`` flavours) with
their arithmetic, comparisons, reductions, indexing and conversions,
the gallery's constructors (``eye``, ``kron``, ``tril``, ``vstack``,
``bmat``, ...) and its seeded generators (``random``, ``powerlaw``,
``rmat``).

Entry points run on ``cuda`` unless the caller names a device
(``device="cpu"``, or ``runtime.set_device("cpu")``); with no CUDA
device and no such request they raise.  The package imports neither
``jax`` nor ``legate_sparse_tpu``.
"""

from . import linalg, runtime
from .coo import coo_array, coo_matrix
from .csc import csc_array, csc_matrix
from .csr import csr_array, csr_matrix, spgemm_csr_csr_csr
from .dia import dia_array, dia_matrix
from .gallery import (block_array, block_diag, bmat, diags, eye, find,
                      hstack, identity, kron, kronsum, powerlaw, random, rmat,
                      spdiags, tril, triu, vstack)
from .types import SparseEfficiencyWarning

__all__ = ["SparseEfficiencyWarning", "block_array", "block_diag", "bmat",
           "coo_array", "coo_matrix", "csc_array", "csc_matrix", "csr_array",
           "csr_matrix", "dia_array", "dia_matrix", "diags", "eye", "find",
           "hstack", "identity", "kron", "kronsum", "linalg", "powerlaw",
           "random", "rmat", "runtime", "spdiags", "spgemm_csr_csr_csr",
           "tril", "triu", "vstack"]
