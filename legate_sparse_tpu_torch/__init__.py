# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""legate_sparse_tpu_torch: the PyTorch/CUDA port of legate_sparse_tpu.

A scipy.sparse-shaped sparse package on PyTorch tensors for an NVIDIA
H100 (``import legate_sparse_tpu_torch as sparse``).  It holds the
main path ``diags(...)`` → ``dia_array.tocsr`` → ``csr_array.dot``
(banded SpMV through the CUDA kernel ``csrc/dia_spmv.cu``, irregular
SpMV through ``csrc/bsr_spmv.cu``) → ``linalg.cg``; SpMM
(``csrc/dia_spmm.cu``, ``csrc/bsr_spmm.cu``); SpGEMM (banded through
``csrc/dia_spgemm.cu``, general by expand-sort-compress); and the apps
``apps.pde`` and ``apps.gmg`` (multigrid-preconditioned CG).

Entry points run on ``cuda`` unless the caller names a device
(``device="cpu"``, or ``runtime.set_device("cpu")``); with no CUDA
device and no such request they raise.  The package imports neither
``jax`` nor ``legate_sparse_tpu``.
"""

from . import linalg, runtime
from .csr import csr_array, csr_matrix
from .dia import dia_array
from .gallery import diags

__all__ = ["csr_array", "csr_matrix", "dia_array", "diags", "linalg",
           "runtime"]
