# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Shape bucketing policy: the quantizer behind the plan cache (the
port of ``legate_sparse_tpu/engine/buckets.py``).

Operands are padded up to a shape bucket with masked tails
(``ops.spmv.csr_spmv_rowids_masked`` drops padded products exactly), so
nearby sizes share one plan and the results stay bit for bit those of
the unpadded products.

Policy: the smallest rung of ``settings.engine_bucket_ladder`` that
holds the value, or, with an empty ladder (the default) or a value
above the top rung, the next power of two; either way at least
``settings.engine_min_bucket``.  Padding stays under 2x under the
power-of-two policy.
"""

from __future__ import annotations

from typing import Optional, Tuple


def next_pow2(value: int) -> int:
    """Smallest power of two >= ``value`` (>= 1)."""
    return 1 << max(int(value) - 1, 0).bit_length()


def bucket(value: int, ladder: Optional[Tuple[int, ...]] = None,
           minimum: Optional[int] = None) -> int:
    """Bucketed size for ``value`` under the active policy
    (``ladder``/``minimum`` default to the live settings)."""
    if ladder is None or minimum is None:
        from ..settings import settings

        if ladder is None:
            ladder = settings.engine_bucket_ladder
        if minimum is None:
            minimum = settings.engine_min_bucket
    value = max(int(value), 1)
    floor = max(int(minimum), 1)
    for rung in ladder:
        if rung >= value:
            return max(rung, floor)
    return max(next_pow2(value), floor)


def k_bucket(k: int) -> int:
    """Bucket of an SpMM plan's column count (the executor's stacked
    batch width): the next power of two, at least 1."""
    return next_pow2(max(int(k), 1))
