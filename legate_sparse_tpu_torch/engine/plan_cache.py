# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Plan cache: bucket-keyed plans (the port of
``legate_sparse_tpu/engine/plan_cache.py``).

A plan serves one bucketed operand shape, keyed on::

    (op, dtype, rows bucket, cols bucket, nnz bucket, k bucket,
     mesh fingerprint, settings epoch)

In the JAX package a plan is an AOT-compiled XLA executable.  Eager
PyTorch compiles nothing, so here a plan is the bucketed eager function
(``BUILDERS``) and building one costs no compile; the cache keeps the
JAX package's identity, LRU, negative cache for failed builds and
ledger, so the ``engine.plan.*`` counts are the same over the same calls.
No CUDA-graph capture: a graph fixes its buffers' addresses, while a
plan serves every matrix of its bucket.  The epoch term retires plans
after a settings change; the mesh fingerprint keys the ledger entries
of distributed dispatches to their mesh and layout.

Counters (always on)::

    engine.plan.hits / engine.plan.misses    aggregate cache outcome
    engine.plan.evictions                    LRU pressure
    engine.plan.build_ms                     cumulative build time
    engine.plan.<plan-id>.hits/.builds/.execs   per-plan rollup
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from .. import obs as _obs
from ..resilience import faults as _rfaults
from ..resilience import outcomes as _routcomes
from ..resilience import policy as _rpolicy


@dataclass(frozen=True)
class PlanKey:
    """Identity of one plan (see module docstring)."""

    op: str                 # "spmv" | "spmm" | "spmv_multi" | "dist_spmv"
    dtype: str              # numpy name of the value dtype
    rows_b: int             # bucketed output rows
    cols_b: int             # bucketed x length
    nnz_b: int              # bucketed stored-entry count
    k_b: int = 1            # bucketed dense-operand width (SpMM/batch)
    mesh_fp: str = ""       # "" = one device; else mesh + layout
    epoch: int = 0          # settings epoch at build time

    @property
    def plan_id(self) -> str:
        """Compact id used in counter names; the mesh/layout fingerprint
        is digested to 8 hex digits."""
        pid = (f"{self.op}/{self.dtype}/r{self.rows_b}/c{self.cols_b}"
               f"/z{self.nnz_b}/k{self.k_b}")
        if self.mesh_fp:
            pid += "/m" + hashlib.sha1(self.mesh_fp.encode()).hexdigest()[:8]
        return pid


@dataclass
class Plan:
    """One cached plan and its ledger.  ``fn`` is the bucketed eager
    function (None for the ledger-only entries of distributed
    dispatches, whose work runs in ``parallel.dist_csr``)."""

    key: PlanKey
    fn: Optional[Callable] = None
    build_ms: float = 0.0
    hits: int = 0
    execs: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)

    def __call__(self, *args):
        self.execs += 1
        _obs.inc(f"engine.plan.{self.key.plan_id}.execs")
        return self.fn(*args)


class PlanBuildError(RuntimeError):
    """Raised for a key whose build already failed (the negative
    cache)."""


class PlanCache:
    """Thread-safe LRU of ``PlanKey -> Plan``."""

    # Bound on the failed-build negative cache.
    _FAILED_CAP = 256

    def __init__(self, capacity: int = 128):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._plans: "OrderedDict[PlanKey, Plan]" = OrderedDict()
        # Keys whose build raised: later lookups fail fast (routing then
        # falls back to the plain dispatch).
        self._failed: set = set()

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def lookup(self, key: PlanKey) -> Optional[Plan]:
        """The plan (LRU-refreshed), or None; counts the hit."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                return None
            self._plans.move_to_end(key)
            plan.hits += 1
        _obs.inc("engine.plan.hits")
        _obs.inc(f"engine.plan.{key.plan_id}.hits")
        return plan

    def get_or_build(self, key: PlanKey,
                     builder: Callable[[PlanKey], Plan]
                     ) -> Tuple[Plan, bool]:
        """``(plan, hit)``.  The build runs outside the lock; two threads
        missing one key may both build (the first insert wins)."""
        plan = self.lookup(key)
        if plan is not None:
            return plan, True
        with self._lock:
            if key in self._failed:
                _obs.inc("engine.plan.failed_fast")
                raise PlanBuildError(
                    f"plan {key.plan_id}: build already failed in "
                    f"this process (cached)")
        _obs.inc("engine.plan.misses")
        _obs.inc(f"engine.plan.{key.plan_id}.builds")
        t0 = time.perf_counter()

        def _build():
            # Resilience site: a failed build is retried under the
            # engine.plan.build policy before it reaches the negative
            # cache.  One flag read with resilience off.
            _rfaults.fault_point("engine.plan.build")
            return builder(key)

        try:
            with _obs.span("engine.build", plan=key.plan_id):
                plan = _rpolicy.run("engine.plan.build", _build)
        except _routcomes.FinalOutcomeError:
            # An open breaker never attempted this key: do not poison
            # the negative cache.
            raise
        except Exception:
            with self._lock:
                if len(self._failed) >= self._FAILED_CAP:
                    self._failed.clear()
                self._failed.add(key)
            _obs.inc("engine.plan.build_failed")
            raise
        plan.build_ms = (time.perf_counter() - t0) * 1e3
        _obs.inc("engine.plan.build_ms", plan.build_ms)
        with self._lock:
            existing = self._plans.get(key)
            if existing is not None:
                plan = existing
            else:
                self._plans[key] = plan
                while len(self._plans) > self.capacity:
                    old_key, _old = self._plans.popitem(last=False)
                    _obs.inc("engine.plan.evictions")
                    _obs.event("engine.plan.evict", plan=old_key.plan_id)
        return plan, False

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._failed.clear()

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-plan ledger snapshot."""
        with self._lock:
            return {
                k.plan_id: {
                    "hits": p.hits,
                    "execs": p.execs,
                    "build_ms": round(p.build_ms, 3),
                    "meta": dict(p.meta),
                }
                for k, p in self._plans.items()
            }


# ---------------------------------------------------------------- builders
#
# Pack layout (``core._pack_for``): data and indices padded to nnz_b,
# x padded to cols_b, and the segment lengths: rows_b rows' lengths (the
# real rows', then zeros), then ``padding_segments(nnz_b)`` segments that
# hold the nnz_b - nnz padded slots and whose sums are dropped.  A padded
# slot never adds to a real row (+0.0 would flip a -0.0 sum), and each
# real row sums its slots in the order of the unpadded product
# (``pack.serial``, the matrix's ``_serial_rows``).  The padding is cut
# into segments of ``PAD_SEGMENT`` slots: summed one thread a segment,
# one long padding segment would be the critical path.  ``kernel`` is
# the pack's segment offsets and CSR SpMV kernel schedule
# (``_Pack.kernel``, built once with the pack), or None; the plans pass
# them on, so a request builds no schedule.
PAD_SEGMENT = 64


def padding_segments(nnz_b: int) -> int:
    """Padding segments of a pack of ``nnz_b`` slots."""
    return max(-(-nnz_b // PAD_SEGMENT), 1)


def build_spmv_plan(key: PlanKey) -> Plan:
    """Bucketed CSR SpMV: the csr-rowids product over the pack."""
    from ..ops import spmv as spmv_ops

    rows, segs = key.rows_b, key.rows_b + padding_segments(key.nnz_b)

    def fn(data, indices, lengths, x, serial, kernel=None):
        offsets, schedule = kernel or (None, None)
        return spmv_ops.csr_spmv_rowids(data, indices, None, x, segs,
                                        lengths=lengths, serial=serial,
                                        offsets=offsets,
                                        schedule=schedule)[:rows]

    return Plan(key, fn=fn, meta={"kernel": "csr_spmv_rowids"})


def build_spmm_plan(key: PlanKey) -> Plan:
    """Bucketed CSR SpMM (also the executor's stacked batch); each
    column sums as the SpMV plan sums its one."""
    from ..ops import spmv as spmv_ops

    rows, segs = key.rows_b, key.rows_b + padding_segments(key.nnz_b)

    def fn(data, indices, lengths, X, serial, kernel=None):
        offsets, schedule = kernel or (None, None)
        return spmv_ops.csr_spmm_rowids(data, indices, None, X, segs,
                                        lengths=lengths, serial=serial,
                                        offsets=offsets,
                                        schedule=schedule)[:rows]

    return Plan(key, fn=fn, meta={"kernel": "csr_spmm_rowids"})


def build_spmv_multi_plan(key: PlanKey) -> Plan:
    """``k_b`` matrices of one shape bucket (different tenants, one
    gateway batch) in one stacked dispatch; slot ``i`` carries matrix
    ``i``'s pack and its own x, and ``kernel`` the real matrices' packs'
    offsets and schedules (the slots past them are batch padding)."""
    from ..ops import spmv as spmv_ops

    rows, b = key.rows_b, key.k_b

    def fn(data, indices, lengths, valid, X, serial, kernel=None):
        return spmv_ops.csr_multi_spmv_rowids_masked(
            data, indices, None, valid, X, rows, b, lengths=lengths,
            serial=serial, kernel=kernel)

    return Plan(key, fn=fn,
                meta={"kernel": "csr_multi_spmv_rowids_masked"})


BUILDERS: Dict[str, Callable[[PlanKey], Plan]] = {
    "spmv": build_spmv_plan,
    "spmm": build_spmm_plan,
    "spmv_multi": build_spmv_multi_plan,
}
