# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Kernels and plain tensor ops (mirrors ``legate_sparse_tpu/ops``).

``dia_kernel``, ``bsr``, ``ell_kernel`` and ``csr_kernel`` each hold a
hand-written CUDA kernel (sources in ``../csrc``, built by ``_build``)
beside its plain PyTorch version; ``convert``, ``spmv`` (whose
``ell_spmv`` routes CUDA operands to ``ell_kernel``, and whose
csr-rowids products route them to ``csr_kernel``), ``spgemm`` and
``dia_ops`` are plain PyTorch.  The package re-exports the JAX package's names: the plain
products, conversions and SpGEMM (``dia_spmv``/``dia_spmm`` are
``dia_ops``' plain DIA products; the kernel wrappers are
``kernel_wrappers()``'s).
"""

from .spmv import csr_spmv, csr_spmm  # noqa: F401
from .convert import (  # noqa: F401
    row_ids_from_indptr,
    indptr_from_row_ids,
    dense_to_csr,
    csr_to_dense,
    coo_to_csr,
    csr_transpose,
    csr_diagonal,
)
from .spgemm import spgemm_csr_csr_csr_impl, coalesce_coo  # noqa: F401
from .dia_ops import dia_spmv, dia_spmm  # noqa: F401


def kernel_wrappers() -> dict:
    """The wrappers of the five kernels that port the JAX package's
    Pallas kernels, by kernel name; each wrapper's ``launches`` counts
    its kernel's CUDA launches in this process (a CPU tensor takes the
    plain version and counts none).  The ELL and CSR SpMV kernels port
    no Pallas kernel; their wrappers ``ell_kernel.ell_spmv`` and
    ``csr_kernel.csr_spmv`` count their own ``launches`` the same way."""
    from . import bsr, dia_kernel

    return {"dia_spmv": dia_kernel.dia_spmv, "bsr_spmv": bsr.bsr_spmv,
            "dia_spmm": dia_kernel.dia_spmm, "bsr_spmm": bsr.bsr_spmm,
            "dia_spgemm": dia_kernel.dia_spgemm}
