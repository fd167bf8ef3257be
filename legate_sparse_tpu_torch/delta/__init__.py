# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Streaming matrix mutation while serving (counterpart of
``legate_sparse_tpu/delta/``).

Off by default behind ``LEGATE_SPARSE_TPU_DELTA`` (``settings.delta``):
a :class:`~.core.DeltaCSR` serves an immutable base ``csr_array`` plus a
bounded COO side-buffer of entry updates as ``base @ x + delta @ x``,
and compaction merges the buffer into a fresh base and swaps versions.
:class:`~.dist.DistDeltaCSR` is its distributed twin on a ``DistCSR``.
"""

from .core import (  # noqa: F401
    DeltaCapacityError, DeltaCSR, DeltaView, is_delta, route,
)
from .dist import DistDeltaCSR  # noqa: F401

__all__ = [
    "DeltaCSR", "DeltaView", "DistDeltaCSR", "DeltaCapacityError",
    "is_delta", "route",
]
