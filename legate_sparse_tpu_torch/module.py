# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The package's public names (mirrors ``legate_sparse_tpu/module.py``):
the array types, the gallery, the io functions, the free ``spmv`` and
``spgemm_csr_csr_csr``, the index types and scipy's predicates
(``issparse``, ``isspmatrix_*``), which answer True for this package's
matrices only, as in the JAX package."""

from .coo import coo_array, coo_matrix  # noqa: F401
from .csc import csc_array, csc_matrix  # noqa: F401
from .csr import csr_array, csr_matrix, spgemm_csr_csr_csr, spmv  # noqa: F401
from .dia import dia_array, dia_matrix  # noqa: F401
from .gallery import (  # noqa: F401
    block_array, block_diag, bmat, diags, eye, find, hstack, identity,
    kron, kronsum, powerlaw, random, rmat, spdiags, tril, triu, vstack,
)
from .io import load_npz, mmread, mmwrite, save_npz  # noqa: F401
from .types import coord_ty, nnz_ty  # noqa: F401
from .utils import is_sparse_matrix  # noqa: F401

__all__ = [
    "block_array", "block_diag", "bmat", "coo_array", "coo_matrix",
    "coord_ty", "csc_array", "csc_matrix", "csr_array", "csr_matrix",
    "dia_array", "dia_matrix", "diags", "eye", "find", "hstack",
    "identity", "is_sparse_matrix", "issparse", "isspmatrix",
    "isspmatrix_coo", "isspmatrix_csc", "isspmatrix_csr", "isspmatrix_dia",
    "kron", "kronsum", "load_npz", "mmread", "mmwrite", "nnz_ty",
    "powerlaw", "random", "rmat", "save_npz", "spdiags",
    "spgemm_csr_csr_csr", "spmv", "tril", "triu", "vstack",
]


def issparse(o) -> bool:
    return is_sparse_matrix(o)


def isspmatrix(o) -> bool:
    return is_sparse_matrix(o)


def isspmatrix_coo(o) -> bool:
    return isinstance(o, coo_array)


def isspmatrix_csc(o) -> bool:
    return isinstance(o, csc_array)


def isspmatrix_csr(o) -> bool:
    return isinstance(o, csr_array)


def isspmatrix_dia(o) -> bool:
    return isinstance(o, dia_array)
