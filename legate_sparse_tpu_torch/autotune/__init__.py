# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Sparsity-fingerprint autotuner: measured kernel selection (the port
of ``legate_sparse_tpu/autotune``).

- :mod:`.fingerprint` — cheap deterministic structure descriptors,
  cached on ``csr_array``, discretized into a class label;
- :mod:`.registry` — the candidate-kernel catalog;
- :mod:`.harness` — warmup and median-of-k candidate races;
- :mod:`.store` — the verdict LRU with epoch and platform invalidation
  and optional JSON warm start.

Routing (``route_matvec`` / ``route_matmat``, consulted by
``csr_array.dot`` right after the engine rung) serves a stored verdict
or silently declines: tuning off (``LEGATE_SPARSE_TPU_AUTOTUNE`` unset,
the default), dtype promotion (save the bf16/f16 -> f32 widening, which
the ``*-bf16`` candidates serve), DIA/BSR structure, or a store miss all
fall through to the heuristic chain.  The engine consults
:func:`plan_preference` in its eligibility check and defers to a
verdict naming a non-CSR kernel.

Off is inert: every dispatch site pays one settings read.  On, a routed
dispatch runs the verdict's kernel exactly as a direct call of it
would: bit for bit.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .. import obs as _obs
from ..settings import settings as _settings_ref
from .fingerprint import Fingerprint, compute_fingerprint  # noqa: F401
from .harness import (  # noqa: F401
    eligible_candidates, measure_candidates, time_kernel, tune,
)
from .registry import CANDIDATES, Candidate  # noqa: F401
from .store import (  # noqa: F401
    Verdict, VerdictKey, VerdictStore, key_for, platform_fingerprint,
)

_store: Optional[VerdictStore] = None
_store_lock = threading.Lock()


def get_store() -> VerdictStore:
    """The process-wide verdict store (created on first use)."""
    global _store
    if _store is None:
        with _store_lock:
            if _store is None:
                _store = VerdictStore()
    return _store


def reset() -> None:
    """Drop the process store."""
    global _store
    with _store_lock:
        _store = None


def autotune_enabled() -> bool:
    """Fast routing check: one attribute read on the settings
    singleton."""
    return _settings_ref.autotune


def route_matvec(A, x):
    """Verdict-routed ``A @ x``: ``(y, label)``, or None (fall through
    to the heuristic dispatch)."""
    if not _settings_ref.autotune:
        return None
    return _route(A, x, "spmv")


def route_matmat(A, X):
    if not _settings_ref.autotune:
        return None
    return _route(A, X, "spmm")


def _route(A, operand, op: str):
    from ..csr import csr_array

    if not isinstance(A, csr_array):
        return None
    widening = False
    if torch.promote_types(A.dtype, operand.dtype) != A.dtype:
        # Verdicts are keyed on the matrix dtype; the one exception is
        # the low-precision widening (bf16/f16 matrix, f32 operand),
        # which the f32-accumulation candidates serve bit for bit.
        widening = (A.dtype in (torch.bfloat16, torch.float16)
                    and torch.promote_types(A.dtype, operand.dtype)
                    == torch.float32)
        if not widening:
            _obs.inc("autotune.route.decline")
            return None
    if A._get_dia() is not None or A._get_bsr() is not None:
        _obs.inc("autotune.route.decline")
        return None  # the banded and block kernels keep priority
    k = 1
    if op == "spmm":
        k = int(operand.shape[1])
        if k == 0:
            _obs.inc("autotune.route.decline")
            return None
    verdict = get_store().lookup(key_for(A, op, k=k))
    if verdict is None:
        _obs.inc("autotune.route.miss")
        return None
    cand = CANDIDATES.get(verdict.label)
    if cand is None or op not in cand.ops or not cand.eligible(A):
        # A stale or foreign verdict naming a kernel this matrix can't
        # run must not error the dispatch.
        _obs.inc("autotune.route.decline")
        return None
    if widening and not verdict.label.endswith("-bf16"):
        _obs.inc("autotune.route.decline")
        return None
    y = cand.run(A, operand, op)
    _obs.inc("autotune.route.hits")
    _obs.inc("autotune.route." + verdict.label)
    return y, verdict.label


def plan_preference(A) -> Optional[str]:
    """The stored SpMV verdict's label for ``A``, or None (tuning off,
    store miss): the engine's consult."""
    if not _settings_ref.autotune:
        return None
    from ..csr import csr_array

    if not isinstance(A, csr_array):
        return None
    verdict = get_store().lookup(key_for(A, "spmv"))
    return verdict.label if verdict is not None else None
