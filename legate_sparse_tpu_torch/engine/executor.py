# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Micro-batching request executor: the admission layer above plans
(the port of ``legate_sparse_tpu/engine/executor.py``).

Serving traffic is many small same-matrix SpMV requests arriving
concurrently.  One SpMV moves the whole matrix for one vector; k stacked
requests move it once for k vectors.  So the executor coalesces
same-matrix submissions into ONE stacked SpMM dispatch, whose columns
are each summed exactly as the SpMV plan sums its one
(``ops.spmv.row_sums``): batching is bit for bit invisible
to callers.

Contract
--------
- ``submit(A, x) -> concurrent.futures.Future`` — thread-safe; callers
  must not mutate ``A`` while requests are in flight.
- A batch dispatches when it reaches ``settings.engine_max_batch``
  requests (in the submitting thread), when its oldest request ages
  past ``settings.engine_batch_timeout_ms`` (the worker thread), or on
  ``flush()``.  ``timeout_ms <= 0`` starts no worker: dispatch happens
  only at max-batch and ``flush``, deterministically.
- Backpressure: at ``settings.engine_queue_depth`` pending requests a
  ``submit`` dispatches the largest group inline, unless some group's
  oldest request is older than 2x the batch timeout, in which case the
  oldest such group goes first (``engine.exec.backpressure_aged``).
- Ineligible submissions (banded or block matrices) dispatch inline
  through ``A.dot``, same Future contract.
- Resilience (``LEGATE_SPARSE_TPU_RESIL``): a request submitted under a
  ``resilience.deadline`` scope carries its deadline; queue wait counts
  against it, and an expired request is shed with the typed
  ``outcomes.Rejected`` value (``resil.shed.*``).
- Shutdown: live executors are tracked in a module WeakSet and drained
  by one ``atexit`` hook, so requests still queued at interpreter exit
  are dispatched, never left with a forever-pending Future.  A failure
  in a worker resolves the requests' futures; it never kills the thread
  silently.

Every dispatch happens in one thread at a time per executor, and
launches on the matrix's device.

Counters: ``engine.exec.submitted`` / ``.batches`` /
``.batched_requests`` / ``.inline`` / ``.backpressure`` /
``.queue_ns``; each dispatch records an ``engine.batch`` span.  Each
request gets an id and one ``engine.request`` span at resolution
(start at submit, with ``queue_ms``, ``batch_ms`` and ``dispatch_ms``),
an ``engine.exec.outcome.<outcome>`` counter, and the histograms
``lat.engine.wait.<outcome>`` (every outcome) and
``lat.engine.request.<shape-bucket>`` (served requests);
``lat.engine.batch_occupancy`` records every batch's width.  The JAX
package's per-tenant attribution calls wait for the attribution slice.
"""

from __future__ import annotations

import atexit
import itertools
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import torch

from .. import obs as _obs
from ..obs import context as _context
from ..obs import latency as _latency
from ..obs import trace as _trace
from ..resilience import deadline as _rdeadline
from ..resilience import faults as _rfaults
from ..resilience import outcomes as _routcomes
from ..settings import settings as _rsettings


# Executors with possibly-queued requests, drained once at interpreter
# exit.  A WeakSet (not per-instance ``atexit.register(self.close)``,
# which would hold a strong reference) so an executor abandoned without
# shutdown() stays garbage-collectable — its _anchors dict pins whole
# matrices, which must not accumulate for process lifetime in a
# long-lived server.
_LIVE_EXECUTORS: "weakref.WeakSet[RequestExecutor]" = weakref.WeakSet()


def _drain_live_executors() -> None:
    for ex in list(_LIVE_EXECUTORS):
        ex.close()


_exit_hook_installed = False


def _install_exit_hook_once() -> None:
    # Installed at FIRST construction, not module import: user code
    # that registers its own atexit hooks after importing this module
    # but before building an executor (the drain-regression drill
    # does) still sees the drain run first under atexit's LIFO order,
    # matching the old per-instance registration point.
    global _exit_hook_installed
    if not _exit_hook_installed:
        _exit_hook_installed = True
        atexit.register(_drain_live_executors)


# Process-unique request ids (itertools.count: next() is GIL-atomic).
_REQUEST_IDS = itertools.count(1)


class _Request:
    __slots__ = ("A", "x", "future", "rid", "t_ns", "t_popped",
                 "deadline", "tctx", "_finished")

    def __init__(self, A, x):
        self.A = A
        self.x = x
        self.future: Future = Future()
        self.rid = next(_REQUEST_IDS)
        # Joins an active caller trace (a gateway-routed submit) or
        # mints one; rides the record because contextvars do not cross
        # into the worker thread that dispatches this request.
        self.tctx = _context.mint(rid=self.rid)
        self.t_ns = time.perf_counter_ns()
        # Stamped when the request is popped from the queue into a
        # dispatch group ("batched"); None when it never queued
        # (inline service, admission shed, rejection).
        self.t_popped: Optional[int] = None
        self._finished = False
        # Captured at submit time from the SUBMITTING thread's scope:
        # the worker thread dispatching later sheds against the
        # request's own budget, not its own (absent) scope.
        self.deadline = (_rdeadline.current() if _rsettings.resil
                         else None)

    def finish(self, outcome: str, t_dispatch: Optional[int] = None,
               batch_k: int = 0) -> None:
        """Close the lifecycle ledger for this request — exactly once,
        whatever path resolved it.  ``queue_ms`` is submit -> popped
        (for never-queued outcomes: submit -> now, the full wait),
        ``batch_ms`` popped -> dispatch-body start, ``dispatch_ms``
        dispatch start -> result."""
        if self._finished:
            return
        self._finished = True
        now = time.perf_counter_ns()
        t_pop = self.t_popped if self.t_popped is not None else now
        queue_ms = (t_pop - self.t_ns) / 1e6
        batch_ms = ((t_dispatch - t_pop) / 1e6
                    if t_dispatch is not None else 0.0)
        dispatch_ms = ((now - t_dispatch) / 1e6
                       if t_dispatch is not None else 0.0)
        _obs.inc(f"engine.exec.outcome.{outcome}")
        # Queue wait for EVERY outcome (the shed and served waits stay
        # comparable); end-to-end latency for requests served.
        _latency.observe(f"lat.engine.wait.{outcome}", queue_ms)
        if outcome in ("resolved", "inline", "fallback"):
            _latency.observe(
                "lat.engine.request."
                + _latency.shape_bucket(self.A.shape[0]),
                (now - self.t_ns) / 1e6)
        _trace.complete_span(
            "engine.request", self.t_ns, now - self.t_ns,
            rid=self.rid, outcome=outcome,
            trace_id=self.tctx.trace_id,
            queue_ms=round(queue_ms, 4),
            batch_ms=round(batch_ms, 4),
            dispatch_ms=round(dispatch_ms, 4),
            batch_k=batch_k)

    def shed(self, site: str, reason: str = "deadline_shed") -> None:
        """Resolve with the typed Rejected outcome (never dispatched)."""
        waited_ms = (time.perf_counter_ns() - self.t_ns) / 1e6
        _obs.inc("resil.shed")
        _obs.inc(f"resil.shed.{site}")
        _obs.event("resil.shed", site=site, reason=reason,
                   waited_ms=round(waited_ms, 3))
        self.finish("shed")
        self.future.set_result(_routcomes.Rejected(
            site=site, reason=reason, waited_ms=waited_ms,
            deadline_ms=(self.deadline.total_ms
                         if self.deadline is not None else None)))


class RequestExecutor:
    def __init__(self, engine, max_batch: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 timeout_ms: Optional[float] = None):
        from ..settings import settings

        self._engine = engine
        self.max_batch = max(int(
            max_batch if max_batch is not None
            else settings.engine_max_batch), 1)
        self.queue_depth = max(int(
            queue_depth if queue_depth is not None
            else settings.engine_queue_depth), 1)
        self.timeout_ms = float(
            timeout_ms if timeout_ms is not None
            else settings.engine_batch_timeout_ms)
        self._cv = threading.Condition()
        # Group token -> ordered requests.  Token is the matrix
        # identity: one group = one stacked dispatch against one pack.
        self._groups: Dict[int, List[_Request]] = {}
        self._anchors: Dict[int, object] = {}   # token -> A (strong ref)
        self._pending = 0
        self._worker: Optional[threading.Thread] = None
        self._shutdown = False
        # Serializes _dispatch bodies: a max-batch dispatch in a
        # submitting thread must not overlap the worker's timeout
        # dispatch.
        self._dispatch_lock = threading.Lock()
        # The worker is a daemon thread, so without the module's atexit
        # drain a request still queued at interpreter exit would never
        # resolve.
        _install_exit_hook_once()
        _LIVE_EXECUTORS.add(self)

    # ---------------- public API ----------------

    def submit(self, A, x) -> Future:
        """Enqueue one SpMV request; resolve via the returned Future."""
        _obs.inc("engine.exec.submitted")
        # Normalize NOW (a list operand would skip the dtype gate), and
        # reject a wrong-shape request here: batched with others, its
        # dispatch error would fail every future in the group.
        x = self._engine._operand(A, x)
        if tuple(x.shape) != (A.shape[1],):
            raise ValueError(
                f"engine submit: operand shape {tuple(x.shape)} does "
                f"not match matrix {A.shape}")
        req = _Request(A, x)
        if _rsettings.resil:
            # Resilience admission point.  An injected queue fault
            # (error kind) degrades to inline service — the Future
            # contract holds and the queue stays consistent; latency
            # kind sleeps HERE, before the deadline check, so queue-
            # admission delay counts against the request's budget.
            try:
                _rfaults.fault_point("engine.exec.queue")
            except _rfaults.InjectedFault:
                _obs.inc("resil.exec.queue_fault_inline")
                self._resolve_inline(req)
                return req.future
            if req.deadline is not None and req.deadline.expired():
                # Shed at admission: an expired request must never be
                # dispatched (it would displace on-time work).
                req.shed("engine.exec.queue")
                return req.future
        if not self._engine._eligible(A, x.dtype):
            # Serve through the normal dispatch, same Future contract.
            _obs.inc("engine.exec.inline")
            self._resolve_inline(req)
            return req.future
        to_dispatch: List[Tuple[object, List[_Request]]] = []
        with self._cv:
            if self._shutdown:
                # Checked under the lock: a submit racing shutdown()
                # must either land before the final flush or raise —
                # never enqueue into a drained queue (orphaned future).
                req.finish("rejected")
                raise RuntimeError("executor is shut down")
            if self._pending >= self.queue_depth:
                # Bounded queue without a deadlockable wait: the
                # submitter pays for the largest group inline.
                _obs.inc("engine.exec.backpressure")
                item = self._pop_largest_locked()
                if item is not None:
                    to_dispatch.append(item)
            token = id(A)
            group = self._groups.setdefault(token, [])
            self._anchors[token] = A
            group.append(req)
            self._pending += 1
            if len(group) >= self.max_batch:
                self._groups.pop(token)
                self._anchors.pop(token)
                self._pending -= len(group)
                self._stamp_popped(group)
                to_dispatch.append((A, group))
            elif self.timeout_ms > 0:
                self._ensure_worker_locked()
                self._cv.notify_all()
        for item in to_dispatch:
            self._dispatch(*item)
        return req.future

    def flush(self) -> None:
        """Dispatch every pending group now, in the calling thread
        (the deterministic drain used by tests and bench)."""
        while True:
            with self._cv:
                item = self._pop_oldest_locked()
            if item is None:
                return
            self._dispatch(*item)

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
            worker = self._worker
        if worker is not None and wait:
            worker.join(timeout=5)
        self.flush()
        try:
            _LIVE_EXECUTORS.discard(self)
        except Exception:  # pragma: no cover - interpreter teardown
            pass

    def close(self) -> None:
        """Idempotent atexit drain: dispatch whatever is still queued
        so no accepted request is dropped at interpreter exit.  A
        dispatch that fails late in teardown delivers its error through
        the request's Future; a residual error is swallowed (an atexit
        hook must not mask the process's real exit)."""
        try:
            self.shutdown(wait=False)
        except Exception:  # pragma: no cover - teardown-order dependent
            pass

    def pending(self) -> int:
        with self._cv:
            return self._pending

    # ---------------- internals ----------------

    @staticmethod
    def _stamp_popped(group: List[_Request]) -> None:
        """Lifecycle transition queued -> batched: the group just left
        the queue as one dispatch unit."""
        now = time.perf_counter_ns()
        for r in group:
            r.t_popped = now

    def _pop_largest_locked(self):
        """Backpressure eviction pick: normally the LARGEST group
        (best amortization for the inline dispatch the submitter is
        about to pay for) — but a largest-first pick alone is unfair
        under sustained load: a small old group can sit behind an
        endless series of fuller ones and never dispatch.  Any group
        whose oldest request has aged past 2x the batch timeout
        therefore wins the pick (oldest such group first); with
        ``timeout_ms <= 0`` (deterministic flush-only mode) the bound
        is zero and the pick is simply oldest-first."""
        if not self._groups:
            return None
        now = time.perf_counter_ns()
        age_bound_ns = 2.0 * self.timeout_ms * 1e6
        aged = [t for t, g in self._groups.items()
                if now - g[0].t_ns >= age_bound_ns]
        if aged:
            _obs.inc("engine.exec.backpressure_aged")
            token = min(aged, key=lambda t: self._groups[t][0].t_ns)
        else:
            token = max(self._groups,
                        key=lambda t: len(self._groups[t]))
        group = self._groups.pop(token)
        A = self._anchors.pop(token)
        self._pending -= len(group)
        self._stamp_popped(group)
        return A, group

    def _pop_oldest_locked(self):
        if not self._groups:
            return None
        token = min(self._groups,
                    key=lambda t: self._groups[t][0].t_ns)
        group = self._groups.pop(token)
        A = self._anchors.pop(token)
        self._pending -= len(group)
        self._stamp_popped(group)
        return A, group

    def _pop_expired_locked(self, now_ns: int):
        limit = self.timeout_ms * 1e6
        ready = []
        for token in [t for t, g in self._groups.items()
                      if now_ns - g[0].t_ns >= limit]:
            group = self._groups.pop(token)
            self._stamp_popped(group)
            ready.append((self._anchors.pop(token), group))
            self._pending -= len(group)
        return ready

    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop,
                name="legate-sparse-engine-executor", daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._shutdown and not self._groups:
                    self._cv.wait()
                if self._shutdown:
                    return
                now = time.perf_counter_ns()
                oldest = min(g[0].t_ns for g in self._groups.values())
                wait_s = (oldest + self.timeout_ms * 1e6 - now) / 1e9
                if wait_s > 0:
                    self._cv.wait(wait_s)
                    continue        # re-evaluate after sleep/notify
                ready = self._pop_expired_locked(now)
            for A, group in ready:
                self._dispatch(A, group)

    def _resolve_inline(self, req: _Request,
                        outcome: str = "inline") -> None:
        # Inline service still decomposes: wait ends HERE (the request
        # leaves the queue path), service time is the dispatch leg —
        # lat.engine.wait.inline must stay comparable to the shed/
        # resolved wait distributions, not absorb A.dot's runtime.
        # ``outcome`` distinguishes never-queued inline service
        # ("inline", ~0 wait) from a queued-and-batched request served
        # here after its batch dispatch failed ("fallback", real
        # queue wait) — conflating them would corrupt the ledger.
        t0 = time.perf_counter_ns()
        if req.t_popped is None:
            req.t_popped = t0
        try:
            with _context.use(req.tctx):
                y = req.A.dot(req.x)
            req.finish(outcome, t_dispatch=t0)
            req.future.set_result(y)
        except BaseException as e:   # noqa: BLE001 - future contract
            req.finish("error", t_dispatch=t0)
            req.future.set_exception(e)

    def _dispatch(self, A, group: List[_Request]) -> None:
        """One stacked dispatch for ``group`` (all against ``A``);
        bodies serialize on ``_dispatch_lock`` (one dispatching thread
        at a time per executor)."""
        with self._dispatch_lock:
            self._dispatch_locked(A, group)

    def _dispatch_locked(self, A, group: List[_Request]) -> None:
        if any(r.deadline is not None for r in group):
            # Flush-time load shedding: queue wait counted against
            # each request's own deadline; expired ones resolve with
            # the typed Rejected outcome instead of being dispatched.
            live = []
            for r in group:
                if r.deadline is not None and r.deadline.expired():
                    r.shed("engine.exec.dispatch")
                else:
                    live.append(r)
            if not live:
                return
            group = live
        k = len(group)
        t_disp = time.perf_counter_ns()
        queue_ns = sum(t_disp - r.t_ns for r in group)
        _obs.inc("engine.exec.batches")
        _obs.inc("engine.exec.batched_requests", k)
        _obs.inc("engine.exec.queue_ns", queue_ns)
        _latency.observe("lat.engine.batch_occupancy", k)
        try:
            # The batch span names every member's trace id, joining
            # each request's flow arc to the batch that served it; a
            # one-request batch also activates that request's context.
            with _obs.span("engine.batch", reqs=k, rows=A.shape[0],
                           nnz=A.nnz,
                           trace_ids=[r.tctx.trace_id for r in group]
                           ) as sp:
                # Eligibility was checked at submit (_checked=True):
                # re-checking would rebuild structure caches per batch
                # for nothing; mutation-in-flight is out of contract.
                if k == 1:
                    with _context.use(group[0].tctx):
                        y = self._engine.matvec(A, group[0].x,
                                                _checked=True)
                    group[0].finish("resolved", t_dispatch=t_disp,
                                    batch_k=1)
                    group[0].future.set_result(y)
                    if sp is not None:
                        sp.set(path="spmv")
                    return
                X = torch.stack([r.x.to(A.dtype) for r in group], dim=1)
                Y = self._engine.matmat(A, X, _checked=True)
                if sp is not None:
                    sp.set(path="spmm", k=k)
                for i, r in enumerate(group):
                    r.finish("resolved", t_dispatch=t_disp, batch_k=k)
                    r.future.set_result(Y[:, i])
        except Exception:
            # Engine-side failure (e.g. a cached plan-build error):
            # the 'engine on is always safe' contract holds for the
            # executor too — serve each request through the normal
            # dispatch; _resolve_inline delivers ITS error if even
            # that fails.
            _obs.inc("engine.exec.dispatch_fallback")
            for r in group:
                if not r.future.done():
                    self._resolve_inline(r, outcome="fallback")
        except BaseException as e:   # noqa: BLE001 - deliver, don't die
            for r in group:
                if not r.future.done():
                    r.finish("error")
                    r.future.set_exception(e)
