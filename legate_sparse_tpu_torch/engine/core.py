# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Execution engine: bucketed plans and request-level dispatch (the port
of ``legate_sparse_tpu/engine/core.py``).

``Engine`` ties the pieces together:

- :mod:`.buckets` quantizes ``(rows, cols, nnz, k)`` to policy buckets;
- :mod:`.plan_cache` holds one plan per bucket key;
- per-matrix *packs* (operands padded to the bucket, cached on the
  ``csr_array`` beside its structure caches) feed the plan without
  padding the matrix on each call;
- :mod:`.executor` micro-batches same-matrix SpMV requests into one
  stacked SpMM dispatch.

The engine routes only matrices whose dispatch would take the gather
(CSR/ELL) paths.  Banded (DIA) and block (BSR) matrices decline and keep
their CUDA kernels.  A process in a ``torch.distributed`` group of more
than one rank declines too.  A declined call falls back to the plain
dispatch, so ``settings.engine = True`` is always safe.

Correctness contract: a bucketed dispatch is bit for bit the unpadded
``csr_spmv_rowids``/``csr_spmm_rowids`` product.  Padded products go to
padding segments whose sums are dropped, and every real row sums its
own slots in the order the unpadded product sums them
(tests/test_torch_engine.py fuzzes this on f32/f64/c64, and
``chip_smoke.py`` phase 16 holds it on the card).  A warm request makes
no host sync: the pack's segment lengths come from ``indptr`` once, at
pack time.  Integer matrices decline.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import obs as _obs
from ..obs import context as _context
from ..resilience import faults as _rfaults
from ..resilience import outcomes as _routcomes
from ..resilience import policy as _rpolicy
from ..settings import settings as _settings_ref
from . import buckets as _buckets
from .plan_cache import (BUILDERS, PAD_SEGMENT, Plan, PlanCache, PlanKey,
                         padding_segments)

_INT32_MAX = np.iinfo(np.int32).max


class _Pack:
    """Bucket-padded operands of one matrix (tensors on its device):
    ``data``/``indices`` padded to ``nnz_b``, the segment ``lengths``
    (``rows_b`` rows, then the padding segments: ``plan_cache``'s pack
    layout), ``valid``, the stored-entry count as a 0-d tensor,
    ``serial``, the order its rows sum in (``csr_array._serial_rows``),
    and ``kernel``, the segments' offsets and the CSR SpMV kernel's
    schedule (``ops/csr_kernel.py``), built once with the pack, or None
    where the kernel does not take the pack's types or device."""

    __slots__ = ("data", "indices", "lengths", "valid", "serial", "rows",
                 "cols", "nnz", "kernel")

    def __init__(self, data, indices, lengths, valid, serial, rows, cols,
                 nnz, kernel=None):
        self.data = data
        self.indices = indices
        self.lengths = lengths
        self.valid = valid
        self.serial = serial
        self.rows = rows
        self.cols = cols
        self.nnz = nnz
        self.kernel = kernel


def _pad_tail(t: torch.Tensor, total: int, fill) -> torch.Tensor:
    """A 1-D tensor padded up to ``total`` with ``fill``."""
    pad = total - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, t.new_full((pad,), fill)])


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype ("float32", "bfloat16"), as the
    JAX package's keys spell it."""
    return str(dtype).replace("torch.", "")


def _multi_rank() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


class Engine:
    """Shape-bucketed plan cache and request executor (one per process
    through :func:`get_engine`; independent instances for tests)."""

    def __init__(self, plan_capacity: Optional[int] = None):
        from ..settings import settings

        self._settings = settings
        self._cache = PlanCache(
            plan_capacity if plan_capacity is not None
            else settings.engine_plan_cache_size)
        self._executor = None
        self._exec_lock = threading.Lock()

    # ---------------- keys / eligibility ----------------

    def _key(self, op: str, rows: int, cols: int, nnz: int,
             dtype, k: int = 1, mesh_fp: str = "") -> PlanKey:
        return PlanKey(
            op=op,
            dtype=_dtype_name(dtype),
            rows_b=_buckets.bucket(rows),
            cols_b=_buckets.bucket(cols),
            nnz_b=_buckets.bucket(nnz),
            k_b=_buckets.k_bucket(k),
            mesh_fp=mesh_fp,
            epoch=self._settings.epoch,
        )

    def _eligible(self, A, x_dtype=None) -> bool:
        """Can this matrix route through bucketed plans?  A decline is
        silent: the caller falls back to the plain dispatch."""
        from ..csr import csr_array

        if not isinstance(A, csr_array):
            return False
        if not (A.dtype.is_floating_point or A.dtype.is_complex):
            return False        # integer products keep index_add_
        if _multi_rank():
            return False        # each rank holds its own blocks
        if x_dtype is not None and torch.promote_types(
                A.dtype, x_dtype) != A.dtype:
            return False        # promotion would rebuild packs per call
        # All three bucketed: the padded nnz_b can cross int32 even
        # where nnz fits.
        if (_buckets.bucket(A.shape[0]) > _INT32_MAX
                or _buckets.bucket(A.shape[1]) > _INT32_MAX
                or _buckets.bucket(A.nnz) > _INT32_MAX):
            return False
        # The banded and block kernels win over shape stability.
        if A._get_dia() is not None or A._get_bsr() is not None:
            return False
        from .. import autotune as _autotune

        pref = _autotune.plan_preference(A)
        if pref is not None and pref != "csr-rowids":
            # A measured verdict picked a non-CSR kernel: defer, and let
            # the autotune route below the engine serve it.
            _obs.inc("autotune.engine.defer")
            return False
        return True

    # ---------------- plans ----------------

    def plan_for(self, op: str, rows: int, cols: int, nnz: int, dtype,
                 k: int = 1, mesh_fp: str = "") -> Plan:
        """Fetch (or build) the plan for a bucketed shape."""
        key = self._key(op, rows, cols, nnz, dtype, k=k, mesh_fp=mesh_fp)
        builder = BUILDERS.get(op)
        if builder is None:
            raise ValueError(f"unknown plan op {op!r}; known: "
                             f"{sorted(BUILDERS)}")
        plan, _hit = self._cache.get_or_build(key, builder)
        return plan

    def warmup(self, plans: Iterable[Dict[str, Any]]) -> List[str]:
        """Build plans before traffic arrives.  Each spec is a dict
        ``{"op": "spmv"|"spmm", "dtype": ..., "rows": n, "cols": m,
        "nnz": z, "k": 1}`` (``cols`` defaults to ``rows``, ``k`` to 1),
        bucketed as live dispatch is.  Returns the plan ids."""
        built = []
        for spec in plans:
            rows = int(spec["rows"])
            plan = self.plan_for(
                spec.get("op", "spmv"), rows, int(spec.get("cols", rows)),
                int(spec["nnz"]), spec.get("dtype", np.float32),
                k=int(spec.get("k", 1)))
            built.append(plan.key.plan_id)
        return built

    # ---------------- per-matrix packs ----------------

    def _pack_for(self, A, key: PlanKey) -> _Pack:
        from ..ops import csr_kernel as _csr_kernel
        from ..ops import spmv as _spmv_ops
        from ..types import coord_dtype_for

        terms = (key.rows_b, key.cols_b, key.nnz_b, key.dtype)
        cached = A._engine_pack
        if cached is not None and cached[0] == terms:
            return cached[1]
        rows, nnz = A.shape[0], A.nnz
        dev = A.device
        cdt = coord_dtype_for(max(key.cols_b, 1))
        data = _pad_tail(A.data, key.nnz_b, 0)
        indices = _pad_tail(A.indices.to(cdt), key.nnz_b, 0)
        # The rows' lengths, zeros for the padded rows, then the padding
        # segments (plan_cache's pack layout): no padded slot ever adds
        # +0.0 to a real row (that would flip a -0.0 sum).  Built from
        # indptr and host integers: no host sync.
        full, rest = divmod(key.nnz_b - nnz, PAD_SEGMENT)
        segs = padding_segments(key.nnz_b)
        i64 = dict(dtype=torch.int64, device=dev)
        lengths = torch.cat([
            A._get_row_lengths().to(torch.int64),
            torch.zeros((key.rows_b - rows,), **i64),
            torch.full((full,), PAD_SEGMENT, **i64),
            torch.full((1,), rest, **i64),
            torch.zeros((segs - full - 1,), **i64)])
        valid = torch.full((), nnz, **i64)
        serial = A._serial_rows()
        kernel = None
        if _spmv_ops.csr_kernel_takes(data, indices, data):
            offsets = _csr_kernel.offsets_from_lengths(lengths)
            kernel = (offsets, _csr_kernel.build_schedule(
                offsets, key.nnz_b, hubs=not serial))
        pack = _Pack(data, indices, lengths, valid, serial, rows,
                     A.shape[1], nnz, kernel)
        A._engine_pack = (terms, pack)
        return pack

    # ---------------- dispatch ----------------

    @staticmethod
    def _operand(A, x) -> torch.Tensor:
        from ..utils import as_tensor

        return as_tensor(x, A.device)

    def matvec(self, A, x, _checked: bool = False):
        """``A @ x`` through the bucketed SpMV plan, or None when the
        matrix is ineligible (the caller falls back)."""
        x = self._operand(A, x)
        if x.dim() != 1 or x.shape[0] != A.shape[1]:
            raise ValueError(
                f"engine.matvec: operand shape {tuple(x.shape)} does not "
                f"match matrix {A.shape}")
        if not _checked and not self._eligible(A, x.dtype):
            return None
        _rfaults.fault_point("engine.exec.dispatch")
        key = self._key("spmv", A.shape[0], A.shape[1], A.nnz, A.dtype)
        plan, _hit = self._cache.get_or_build(key, BUILDERS["spmv"])
        pack = self._pack_for(A, key)
        x_p = _pad_tail(x.to(A.dtype), key.cols_b, 0)
        # A request-scoped dispatch (the gateway and the executor set
        # the context) annotates the profiler as engine.spmv[<id>].
        with _context.profiler_scope("engine.spmv"):
            y_p = plan(pack.data, pack.indices, pack.lengths, x_p,
                       pack.serial, pack.kernel)
        return y_p[: A.shape[0]]

    def matmat(self, A, X, _checked: bool = False):
        """``A @ X`` (dense ``(cols, k)``) through the bucketed SpMM
        plan, or None when ineligible.  ``k`` is bucketed too: zero
        columns are padded in and sliced back off."""
        X = self._operand(A, X)
        if X.dim() != 2 or X.shape[0] != A.shape[1]:
            raise ValueError(
                f"engine.matmat: operand shape {tuple(X.shape)} does not "
                f"match matrix {A.shape}")
        if not _checked and not self._eligible(A, X.dtype):
            return None
        k = int(X.shape[1])
        if k == 0:
            return None
        _rfaults.fault_point("engine.exec.dispatch")
        key = self._key("spmm", A.shape[0], A.shape[1], A.nnz, A.dtype,
                        k=k)
        plan, _hit = self._cache.get_or_build(key, BUILDERS["spmm"])
        pack = self._pack_for(A, key)
        X_p = X.new_zeros((key.cols_b, key.k_b), dtype=A.dtype)
        X_p[: X.shape[0], :k] = X
        with _context.profiler_scope("engine.spmm"):
            Y_p = plan(pack.data, pack.indices, pack.lengths, X_p,
                       pack.serial, pack.kernel)
        return Y_p[: A.shape[0], :k]

    def multi_matvec(self, pairs, _checked: bool = False):
        """``[A_i @ x_i]`` for matrices of ONE shape bucket in a single
        stacked dispatch (the gateway's cross-tenant batch).  A mismatch
        of buckets raises; None when a matrix is ineligible or the
        stacked segment count would leave int32, or the matrices' rows
        sum in different orders (``_Pack.serial``): the caller falls back
        to per-request dispatch.  Each result is bit for bit its own
        plan's."""
        if not pairs:
            return []
        if len(pairs) == 1:
            A, x = pairs[0]
            y = self.matvec(A, x, _checked=_checked)
            return None if y is None else [y]
        pairs = [(A, self._operand(A, x)) for A, x in pairs]
        if not _checked:
            for A, x in pairs:
                if not self._eligible(A, x.dtype):
                    return None
        A0 = pairs[0][0]
        key = self._key("spmv_multi", A0.shape[0], A0.shape[1], A0.nnz,
                        A0.dtype, k=len(pairs))
        terms = (key.rows_b, key.cols_b, key.nnz_b, key.dtype)
        for A, _x in pairs[1:]:
            k1 = self._key("spmv", A.shape[0], A.shape[1], A.nnz, A.dtype)
            if (k1.rows_b, k1.cols_b, k1.nnz_b, k1.dtype) != terms:
                raise ValueError("engine.multi_matvec: matrices span "
                                 "different shape buckets")
        if key.k_b * (key.rows_b + padding_segments(key.nnz_b)) \
                > _INT32_MAX:
            return None
        packs = [self._pack_for(A, key) for A, _x in pairs]
        if len({p.serial for p in packs}) > 1:
            return None
        _rfaults.fault_point("engine.exec.dispatch")
        plan, _hit = self._cache.get_or_build(key, BUILDERS["spmv_multi"])
        b_pad = key.k_b - len(pairs)
        # Batch-padding slots reuse pack 0 with valid 0 (every product
        # masked to an exact 0) and a zero operand.
        data = torch.stack([p.data for p in packs] + [packs[0].data] * b_pad)
        indices = torch.stack([p.indices for p in packs]
                              + [packs[0].indices] * b_pad)
        lengths = torch.stack([p.lengths for p in packs]
                              + [packs[0].lengths] * b_pad)
        valid = torch.stack([p.valid for p in packs]
                            + [torch.zeros_like(packs[0].valid)] * b_pad)
        X = A0.data.new_zeros((key.k_b, key.cols_b))
        for i, (A, x) in enumerate(pairs):
            X[i, : x.shape[0]] = x
        with _context.profiler_scope("engine.spmv_multi"):
            Y = plan(data, indices, lengths, valid, X, packs[0].serial,
                     [p.kernel for p in packs]
                     if packs[0].kernel is not None else None)
        return [Y[i, : A.shape[0]] for i, (A, _x) in enumerate(pairs)]

    def traceable_matvec(self, A) -> Optional[Callable]:
        """An ``x -> A @ x`` closure over the bucketed plan and the pack
        built now, for solver loops (``linalg``); None when ineligible.
        The JAX package's closure runs inside the solver's trace; here
        the solver loop is eager and the closure spares it the
        per-call eligibility checks.  ``mv.pack`` is the pack the closure
        reads: a mutation of ``A`` clears ``A._engine_pack``, so
        ``A._engine_pack[1] is mv.pack`` iff the closure still reads the
        live operands."""
        if not self._eligible(A):
            return None
        key = self._key("spmv", A.shape[0], A.shape[1], A.nnz, A.dtype)
        plan, _hit = self._cache.get_or_build(key, BUILDERS["spmv"])
        pack = self._pack_for(A, key)
        n, cols_b, dtype, fn = A.shape[0], key.cols_b, A.dtype, plan.fn

        def mv(x):
            x_p = _pad_tail(x.to(dtype), cols_b, 0)
            return fn(pack.data, pack.indices, pack.lengths, x_p,
                      pack.serial, pack.kernel)[:n]

        mv.pack = pack
        return mv

    def record_dist_plan(self, A, op: str = "dist_spmv") -> bool:
        """Ledger one distributed dispatch against its plan identity
        (mesh fingerprint, layout, dtype, epoch): the evidence that a
        second matrix of the same layout on the same mesh reuses the
        structure ``parallel.dist_csr`` built.  ``dist_spmv`` calls this
        when routing is on.  True on a plan hit."""
        from ..parallel.dist_csr import dist_plan_fingerprint

        key = PlanKey(
            op=op,
            dtype=_dtype_name(A.dtype),
            rows_b=A.rows_padded,
            cols_b=A.shape[1],
            nnz_b=0,
            k_b=1,
            mesh_fp=dist_plan_fingerprint(A),
            epoch=self._settings.epoch,
        )
        plan, hit = self._cache.get_or_build(
            key, lambda k: Plan(k, meta={"kind": op}))
        plan.execs += 1
        _obs.inc(f"engine.plan.{key.plan_id}.execs")
        return hit

    def dist_matvec(self, A, x):
        """``dist_spmv`` with its plan-ledger entry recorded (recorded
        here only when routing is off: on, ``dist_spmv`` records)."""
        from ..parallel.dist_csr import dist_spmv

        if not _settings_ref.engine:
            self.record_dist_plan(A)
        return dist_spmv(A, x)

    # ---------------- executor ----------------

    @property
    def executor(self):
        """The request executor, built on first use."""
        if self._executor is None:
            with self._exec_lock:
                if self._executor is None:
                    from .executor import RequestExecutor

                    self._executor = RequestExecutor(self)
        return self._executor

    def submit(self, A, x):
        """Asynchronous SpMV: enqueue for micro-batching, get a Future."""
        return self.executor.submit(A, x)

    # ---------------- introspection ----------------

    def stats(self) -> Dict[str, Any]:
        return {"plans": self._cache.stats(),
                "counters": _obs.counters.snapshot("engine.")}

    def clear(self) -> None:
        """Drop every cached plan."""
        self._cache.clear()

    def shutdown(self) -> None:
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None


# ---------------------------------------------------------------- singleton

_engine: Optional[Engine] = None
_engine_lock = threading.Lock()


def get_engine() -> Engine:
    """The process-wide engine (created on first use)."""
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = Engine()
    return _engine


def reset_engine() -> None:
    """Tear down the process-wide engine."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.shutdown()
        _engine = None


def engine_enabled() -> bool:
    """The routing switch: one attribute read."""
    return _settings_ref.engine


def route_matvec(A, x):
    """Dispatch-site helper: the engine's result, or None (fall through
    to the plain dispatch).

    Routing never makes ``A @ x`` fail where the plain dispatch would
    succeed: a plan build or dispatch error is counted
    (``engine.route.error``) and falls back.  With resilience on this is
    the top rung of the ladder: failures retry under the
    ``engine.exec.dispatch`` policy, and K consecutive failures open its
    breaker, which short-circuits the engine rung (None: the plain
    dispatch serves) until its half-open probe heals it."""
    return _route(A, x, "matvec", "spmv")


def route_matmat(A, X):
    return _route(A, X, "matmat", "spmm")


def _route(A, operand, method: str, op: str):
    if not engine_enabled():
        return None
    if _settings_ref.resil:
        try:
            return _rpolicy.run(
                "engine.exec.dispatch",
                lambda: getattr(get_engine(), method)(A, operand),
                fallback=lambda: _route_error(op, "ladder_flip"))
        except _routcomes.FinalOutcomeError:
            # A nested verdict (an open engine.plan.build breaker) must
            # not escape A @ x: the engine rung is unavailable.
            return _route_error(op, "final_outcome_ladder_flip")
    try:
        return getattr(get_engine(), method)(A, operand)
    except Exception as e:
        return _route_error(op, repr(e)[:200])


def _route_error(op: str, error: str):
    _obs.inc("engine.route.error")
    _obs.event("engine.route.error", op=op, error=error)
    return None


def warmup(plans: Iterable[Dict[str, Any]]) -> List[str]:
    """``get_engine().warmup(plans)``."""
    return get_engine().warmup(plans)
