# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Shared base class of the compressed formats.

Mirrors the part of ``legate_sparse_tpu/base.py::CompressedBase`` that
``csr_array`` and ``dia_array`` need: format dispatch, ``astype`` with
structure sharing, and the array-protocol basics (``ndim``, ``device``,
``@``).  Subclasses provide ``shape``, ``dtype``, ``nnz``, ``data``,
``copy`` and ``_with_data``.
"""

from __future__ import annotations

import torch

from .types import to_torch_dtype


class CompressedBase:
    format: str = ""
    shape: tuple

    @property
    def ndim(self) -> int:
        return 2

    @property
    def device(self) -> torch.device:
        return self.data.device

    def asformat(self, format, copy: bool = False):
        """Dispatch to ``to<format>()`` (reference ``base.py:92-108``)."""
        if format is None or format == self.format:
            return self.copy() if copy else self
        convert = getattr(self, "to" + format, None)
        if convert is None:
            raise ValueError(f"Format {format} is unknown.")
        return convert(copy=copy)

    def astype(self, dtype, casting: str = "unsafe", copy: bool = True):
        """Cast the values, sharing structure (reference ``base.py:198-206``)."""
        dtype = to_torch_dtype(dtype)
        if self.dtype != dtype:
            return self._with_data(self.data.to(dtype))
        return self.copy() if copy else self

    def __matmul__(self, other):
        return self.dot(other)
