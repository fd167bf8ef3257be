# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Carry matrices in and out of the port as numpy arrays.

``csr_from_parts``, ``csc_from_parts``, ``coo_from_parts`` and
``dia_from_parts`` take host arrays — such as ``np.asarray(A_jax.data)``
of the JAX package's matrices, bf16 ones included — and build the
port's arrays on a device; ``to_numpy_parts`` gives the arrays back
(bf16 values as float32).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .coo import coo_array
from .csc import csc_array
from .csr import csr_array
from .dia import dia_array
from .runtime import resolve_device
from .utils import to_numpy


def csr_from_parts(data, indices, indptr, shape: Tuple[int, int],
                   device=None) -> csr_array:
    """A ``csr_array`` on ``device`` (default: the runtime's default
    device) from host CSR arrays."""
    return csr_array((data, indices, indptr), shape=tuple(shape),
                     device=resolve_device(device))


def csc_from_parts(data, indices, indptr, shape: Tuple[int, int],
                   device=None) -> csc_array:
    """A ``csc_array`` on ``device`` from host CSC arrays (``indices``
    are row ids, ``indptr`` runs over columns)."""
    return csc_array((data, indices, indptr), shape=tuple(shape),
                     device=resolve_device(device))


def coo_from_parts(data, row, col, shape: Tuple[int, int],
                   device=None) -> coo_array:
    """A ``coo_array`` on ``device`` from host COO arrays."""
    return coo_array((data, (row, col)), shape=tuple(shape),
                     device=resolve_device(device))


def dia_from_parts(data, offsets, shape: Tuple[int, int],
                   device=None) -> dia_array:
    """A ``dia_array`` on ``device`` from host DIA arrays (scipy layout)."""
    return dia_array((data, np.asarray(offsets)), shape=tuple(shape),
                     device=resolve_device(device))


def to_numpy_parts(A) -> tuple:
    """As host numpy arrays: ``(data, indices, indptr)`` of a
    ``csr_array`` or a ``csc_array`` (in CSC layout), ``(data, row,
    col)`` of a ``coo_array``, ``(data, offsets)`` of a ``dia_array``."""
    if isinstance(A, (csr_array, csc_array)):
        return to_numpy(A.data), to_numpy(A.indices), to_numpy(A.indptr)
    if isinstance(A, coo_array):
        return to_numpy(A.data), to_numpy(A.row), to_numpy(A.col)
    if isinstance(A, dia_array):
        return to_numpy(A.data), np.asarray(A.offsets_tuple, dtype=np.int64)
    raise TypeError(f"expected a csr, csc, coo or dia array, got "
                    f"{type(A).__name__}")
