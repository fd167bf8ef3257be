# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Multi-tenant admission gateway: QoS, fairness, and overload policy
(the port of ``legate_sparse_tpu/engine/gateway.py``).

The executor (``engine/executor.py``) batches well but queues naively:
one FIFO, so a single flooding caller starves everyone and overload
behavior degrades to whatever backpressure happens to evict.  The
gateway is the admission layer a serving deployment puts in front of
it — per-tenant policy *before* work enters the system:

- **QoS classes** — every request names one of
  ``interactive`` / ``batch`` / ``background`` (:data:`QOS_CLASSES`),
  which sets its weighted-fair-queueing weight and its place in the
  eviction order.
- **Token-bucket rate limits** (``settings.gateway_rate`` requests/s,
  ``settings.gateway_burst`` capacity, per tenant) and **queue
  quotas** (``settings.gateway_tenant_quota`` queued requests per
  tenant): a tenant past its budget is rejected with a typed
  ``outcomes.Rejected`` (reason ``quota`` / ``queue_full``) — its
  flood never occupies another tenant's queue capacity.
- **Weighted fair queueing** — admitted requests get virtual finish
  tags (``start = max(V, tenant_last_finish)``,
  ``tag = start + 1/weight``); batches are formed in ascending-tag
  order across tenant FIFOs, so service share converges to the weight
  ratio regardless of arrival rates.  Requests against *different*
  matrices that land in the same plan-cache shape bucket pack into
  ONE stacked dispatch (``Engine.multi_matvec``; bit-for-bit equal to
  per-request dispatch — kernel contract).
- **Deadline-aware batching** — a request whose deadline slack is
  below ``settings.gateway_slack_ms`` is dispatched immediately (it
  seeds a batch in the submitting thread) instead of waiting for a
  fuller batch; an expired request is shed (reason ``deadline_shed``)
  at admission or at the dispatch flush, never executed.
- **Backpressure** — at ``settings.gateway_queue_depth`` total queued
  requests, admission evicts by *least slack within the lowest QoS
  class* (reason ``queue_full``); when the incoming request is itself
  the weakest candidate it is the one rejected.
- **Breaker-degraded mode** — while the ``gateway.dispatch`` circuit
  breaker is open, non-interactive admissions are shed (reason
  ``breaker``) and interactive ones are served inline through the
  plain dispatch: graceful degradation instead of a queue collapsing
  onto a broken dispatch path.

Isolation is the contract: one tenant's injected faults
(``gateway.admit`` / ``gateway.dispatch`` sites), breaker trips, or
deadline storms must not corrupt another tenant's results or starve
its queue.  (The JAX package's chaos drill of this contract waits for
the port of ``resilience/chaos``.)

Matrices the engine declines (banded, block) are served inline through
``A.dot``, which launches their CUDA kernels.  With ``settings.delta``
on, a submitted ``DeltaCSR`` is pinned to its current view at
admission.  Not ported yet: the JAX package's per-tenant attribution
calls and its ``placement`` branches (each gated on its own setting).

Inert by default: with ``LEGATE_SPARSE_TPU_GATEWAY`` unset no call
path routes through the gateway, and ``Gateway.submit`` itself
degrades to a transparent inline dispatch emitting no ``gateway.*``
telemetry — behavior and counters are exactly the engine's.

Counters: ``gateway.submitted`` /
``.admitted`` / ``.inline`` / ``.evicted`` / ``.dispatches`` /
``.dispatched_requests`` / ``.packed`` / ``.dispatch_fallback`` /
``.admit_fault_inline`` / ``.dispatch_fault_inline`` /
``.breaker_inline``; per reason ``gateway.rejected.<reason>``; per
outcome ``gateway.outcome.<outcome>``; per tenant
``gateway.tenant.<tenant>.submitted`` / ``.served`` / ``.shed`` /
``.error``.  Histograms: ``lat.gateway.wait.<qos>`` (admission ->
resolution wait, every outcome), ``lat.gateway.request.<qos>``
(end-to-end, served only), ``lat.gateway.batch_occupancy``.
"""

from __future__ import annotations

import atexit
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, List, Optional

import torch

from .. import obs as _obs
from ..obs import context as _context
from ..obs import latency as _latency
from ..resilience import deadline as _rdeadline
from ..resilience import faults as _rfaults
from ..resilience import outcomes as _routcomes
from ..resilience import policy as _rpolicy
from ..settings import settings as _rsettings
from .executor import _REQUEST_IDS

#: QoS classes in priority order (index = eviction rank: background is
#: evicted first, interactive last).
QOS_CLASSES = ("interactive", "batch", "background")

#: Default WFQ weights per class — an interactive request costs 1/8th
#: of a background request in virtual time, so under contention the
#: service ratio converges to 8:4:1.
QOS_WEIGHTS = {"interactive": 8.0, "batch": 4.0, "background": 1.0}

_QOS_RANK = {c: i for i, c in enumerate(QOS_CLASSES)}


class TokenBucket:
    """Per-tenant admission rate limit on the monotonic-ns clock.

    ``rate <= 0`` disables the limit (always admits).  Call under the
    gateway lock; refill is computed lazily from elapsed ns, so an
    idle tenant accrues burst capacity without any timer thread."""

    __slots__ = ("rate", "burst", "_tokens", "_t_ns")

    def __init__(self, rate_per_s: float, burst: float):
        self.rate = float(rate_per_s)
        self.burst = max(float(burst), 1.0)
        self._tokens = self.burst
        self._t_ns = time.monotonic_ns()

    def try_take(self) -> bool:
        if self.rate <= 0:
            return True
        now_ns = time.monotonic_ns()
        self._tokens = min(
            self.burst,
            self._tokens + (now_ns - self._t_ns) / 1e9 * self.rate)
        self._t_ns = now_ns
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class _Tenant:
    """Per-tenant admission state: FIFO of queued requests, WFQ last
    finish tag, token bucket."""

    __slots__ = ("name", "queue", "vfinish", "bucket")

    def __init__(self, name: str, rate: float, burst: float):
        self.name = name
        self.queue: List[_GwRequest] = []
        self.vfinish = 0.0
        self.bucket = TokenBucket(rate, burst)


class _GwRequest:
    """One gateway request and its exactly-once lifecycle ledger."""

    __slots__ = ("A", "x", "future", "rid", "tenant", "qos", "rank",
                 "vtag", "t_ns", "deadline", "shape_key", "tctx",
                 "_finished")

    def __init__(self, A, x, tenant: str, qos: str):
        self.A = A
        self.x = x
        self.future: Future = Future()
        self.rid = next(_REQUEST_IDS)
        self.tenant = tenant
        self.qos = qos
        # Rides the record across the drain-worker thread: the admit
        # span, the batch span's member list and the dispatch spans all
        # carry this id, one flow arc per request.
        self.tctx = _context.mint(rid=self.rid, tenant=tenant, qos=qos)
        self.rank = _QOS_RANK[qos]
        self.vtag = 0.0
        self.t_ns = time.perf_counter_ns()
        # Submitting thread's deadline scope (same capture rule as the
        # executor: later dispatch sheds against the REQUEST's budget).
        self.deadline = (_rdeadline.current() if _rsettings.resil
                         else None)
        self.shape_key = None
        self._finished = False

    def slack_ms(self) -> float:
        """Milliseconds until this request's deadline (inf without
        one) — the urgency/eviction ordering term."""
        if self.deadline is None:
            return float("inf")
        return self.deadline.remaining_ms()

    def _finish(self, outcome: str) -> bool:
        """Close the ledger exactly once; False when already closed."""
        if self._finished:
            return False
        self._finished = True
        wait_ms = (time.perf_counter_ns() - self.t_ns) / 1e6
        _obs.inc(f"gateway.outcome.{outcome}")
        _latency.observe(f"lat.gateway.wait.{self.qos}", wait_ms)
        if outcome == "served":
            _latency.observe(f"lat.gateway.request.{self.qos}",
                             wait_ms)
        return True

    def serve(self, y) -> None:
        if not self._finish("served"):
            return
        _obs.inc(f"gateway.tenant.{self.tenant}.served")
        self.future.set_result(y)

    def shed(self, site: str, reason: str) -> None:
        if not self._finish("shed"):
            return
        waited_ms = (time.perf_counter_ns() - self.t_ns) / 1e6
        _obs.inc(f"gateway.rejected.{reason}")
        _obs.inc(f"gateway.tenant.{self.tenant}.shed")
        _obs.event("gateway.shed", site=site, reason=reason,
                   tenant=self.tenant, qos=self.qos,
                   waited_ms=round(waited_ms, 3))
        self.future.set_result(_routcomes.Rejected(
            site=site, reason=reason, waited_ms=waited_ms,
            deadline_ms=(self.deadline.total_ms
                         if self.deadline is not None else None),
            tenant=self.tenant))

    def error(self, exc: BaseException) -> None:
        if not self._finish("error"):
            return
        _obs.inc(f"gateway.tenant.{self.tenant}.error")
        self.future.set_exception(exc)


# Gateways with possibly-queued requests, drained at interpreter exit
# (same WeakSet discipline as the executor's: abandoned instances stay
# collectable).
_LIVE_GATEWAYS: "weakref.WeakSet[Gateway]" = weakref.WeakSet()
_exit_hook_installed = False


def _drain_live_gateways() -> None:
    for gw in list(_LIVE_GATEWAYS):
        gw.close()


def _install_exit_hook_once() -> None:
    global _exit_hook_installed
    if not _exit_hook_installed:
        _exit_hook_installed = True
        atexit.register(_drain_live_gateways)


class Gateway:
    """Multi-tenant admission gateway over one :class:`Engine` (module
    docstring).  Constructor knobs default to the ``gateway_*``
    settings; tests pass explicit values for determinism
    (``timeout_ms=0`` disables the drain worker — dispatch happens
    only on max-batch, urgency, and ``flush()``)."""

    def __init__(self, engine=None, *, max_batch: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 slack_ms: Optional[float] = None,
                 timeout_ms: Optional[float] = None):
        from .core import get_engine

        s = _rsettings
        self._engine = engine if engine is not None else get_engine()
        self.max_batch = max(int(max_batch if max_batch is not None
                                 else s.gateway_max_batch), 1)
        self.queue_depth = max(int(
            queue_depth if queue_depth is not None
            else s.gateway_queue_depth), 1)
        self.tenant_quota = max(int(
            tenant_quota if tenant_quota is not None
            else s.gateway_tenant_quota), 1)
        self.rate = float(rate if rate is not None else s.gateway_rate)
        self.burst = float(burst if burst is not None
                           else s.gateway_burst)
        self.slack_ms = float(slack_ms if slack_ms is not None
                              else s.gateway_slack_ms)
        self.timeout_ms = float(timeout_ms if timeout_ms is not None
                                else s.gateway_timeout_ms)
        self._cv = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}
        self._pending = 0
        self._vtime = 0.0
        self._shutdown = False
        self._worker: Optional[threading.Thread] = None
        # One dispatching thread at a time (as in the executor).
        self._dispatch_lock = threading.Lock()
        _install_exit_hook_once()
        _LIVE_GATEWAYS.add(self)

    # ---------------- public API ----------------

    def submit(self, A, x, tenant: str = "default",
               qos: str = "batch") -> Future:
        """Admit one SpMV request for ``tenant`` at ``qos``; resolve
        via the returned Future (a result array, a typed
        ``outcomes.Rejected``, or an exception)."""
        if qos not in _QOS_RANK:
            raise ValueError(f"unknown qos {qos!r}; one of "
                             f"{QOS_CLASSES}")
        x = self._engine._operand(A, x)
        if tuple(x.shape) != (A.shape[1],):
            raise ValueError(
                f"gateway submit: operand shape {tuple(x.shape)} does "
                f"not match matrix {A.shape}")
        if not _rsettings.gateway:
            # Inert mode: transparent inline dispatch, no gateway.*
            # telemetry — bit-for-bit and counter-inert vs the plain
            # path (the off-by-default contract).
            fut: Future = Future()
            try:
                fut.set_result(A.dot(x))
            except BaseException as e:  # noqa: BLE001 - future contract
                fut.set_exception(e)
            return fut
        if _rsettings.delta:
            # Versioned mutation serving: a submitted DeltaCSR swaps
            # for its current immutable view (the version pinned NOW),
            # so in-flight requests drain on the view they were
            # admitted with.  One flag read while delta is off.
            from ..delta import core as _delta

            A = _delta.route(A)
        req = _GwRequest(A, x, tenant=str(tenant), qos=qos)
        # The admission decision runs under the request's trace
        # context, in one ``gateway.admit`` span (the first anchor of
        # its flow arc).  Batch dispatch stays outside: a batch serves
        # several requests and names them in its ``trace_ids``.
        batch = None
        with _context.use(req.tctx), \
                _obs.span("gateway.admit", rid=req.rid,
                          tenant=req.tenant, qos=req.qos):
            _obs.inc("gateway.submitted")
            _obs.inc(f"gateway.tenant.{req.tenant}.submitted")
            if _rsettings.resil:
                # Admission fault site: error kind degrades to inline
                # service (Future contract holds, queue stays
                # consistent); latency kind sleeps HERE so admission
                # delay counts against the request's own deadline.
                try:
                    _rfaults.fault_point("gateway.admit")
                except _rfaults.InjectedFault:
                    _obs.inc("gateway.admit_fault_inline")
                    self._serve_inline(req)
                    return req.future
                if req.deadline is not None and req.deadline.expired():
                    req.shed("gateway.admit", "deadline_shed")
                    return req.future
                if _rpolicy.breaker("gateway.dispatch").state == "open":
                    # Degraded mode: the dispatch path is tripped —
                    # shed deferrable classes instead of queueing onto
                    # a broken path; interactive traffic is served
                    # inline through the plain dispatch.
                    if req.rank > 0:
                        req.shed("gateway.admit", "breaker")
                        return req.future
                    _obs.inc("gateway.breaker_inline")
                    self._serve_inline(req)
                    return req.future
            if not self._engine._eligible(A, x.dtype):
                _obs.inc("gateway.inline")
                self._serve_inline(req)
                return req.future
            key = self._engine._key("spmv", A.shape[0], A.shape[1],
                                    A.nnz, A.dtype)
            req.shape_key = (key.rows_b, key.cols_b, key.nnz_b,
                             key.dtype)
            to_shed: List = []   # (request, site, reason), shed unlocked
            with self._cv:
                if self._shutdown:
                    raise RuntimeError("gateway is shut down")
                ten = self._tenants.get(req.tenant)
                if ten is None:
                    ten = self._tenants[req.tenant] = _Tenant(
                        req.tenant, self.rate, self.burst)
                if not ten.bucket.try_take():
                    to_shed.append((req, "gateway.admit", "quota"))
                elif len(ten.queue) >= self.tenant_quota:
                    to_shed.append((req, "gateway.admit", "queue_full"))
                else:
                    admitted = True
                    if self._pending >= self.queue_depth:
                        victim = self._evict_pick_locked()
                        # Evict only a candidate strictly weaker than
                        # the incoming request; otherwise the incoming
                        # request IS the weakest and is the one
                        # rejected.
                        if (victim is not None
                                and self._evict_key(victim)
                                > self._evict_key(req)):
                            self._remove_locked(victim)
                            _obs.inc("gateway.evicted")
                            to_shed.append(
                                (victim, "gateway.admit", "queue_full"))
                        else:
                            admitted = False
                            to_shed.append(
                                (req, "gateway.admit", "queue_full"))
                    if admitted:
                        _obs.inc("gateway.admitted")
                        start = max(self._vtime, ten.vfinish)
                        weight = QOS_WEIGHTS[req.qos]
                        req.vtag = ten.vfinish = start + 1.0 / weight
                        ten.queue.append(req)
                        self._pending += 1
                        urgent = req.slack_ms() <= self.slack_ms
                        if urgent:
                            batch = self._pop_batch_locked(seed=req)
                        elif self._pending >= self.max_batch:
                            batch = self._pop_batch_locked()
                        elif self.timeout_ms > 0:
                            self._ensure_worker_locked()
                            self._cv.notify_all()
            for victim, site, reason in to_shed:
                victim.shed(site, reason)
        if batch:
            self._dispatch(batch)
        return req.future

    def flush(self) -> None:
        """Dispatch every queued request now, in the calling thread
        (deterministic drain for tests and bench)."""
        while True:
            with self._cv:
                batch = self._pop_batch_locked()
            if not batch:
                return
            self._dispatch(batch)

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
            worker = self._worker
        if worker is not None and wait:
            worker.join(timeout=5)
        self.flush()
        try:
            _LIVE_GATEWAYS.discard(self)
        except Exception:  # pragma: no cover - interpreter teardown
            pass

    def close(self) -> None:
        """Idempotent atexit drain (executor ``close`` contract)."""
        try:
            self.shutdown(wait=False)
        except Exception:  # pragma: no cover - teardown-order dependent
            pass

    def pending(self) -> int:
        with self._cv:
            return self._pending

    def stats(self) -> Dict[str, object]:
        """Point-in-time queue snapshot (counters carry the ledger)."""
        with self._cv:
            return {
                "pending": self._pending,
                "tenants": {t.name: len(t.queue)
                            for t in self._tenants.values()},
                "vtime": self._vtime,
            }

    # ---------------- queue internals (hold self._cv) ----------------

    @staticmethod
    def _evict_key(r: _GwRequest):
        """Eviction preference, descending: lowest class first, then
        least slack (the request least likely to make its deadline
        anyway), newest last as the deterministic tie-break."""
        slack = r.slack_ms()
        return (r.rank, -slack if slack != float("inf") else
                float("-inf"), r.rid)

    def _evict_pick_locked(self) -> Optional[_GwRequest]:
        best = None
        for ten in self._tenants.values():
            for r in ten.queue:
                if best is None or self._evict_key(r) > \
                        self._evict_key(best):
                    best = r
        return best

    def _remove_locked(self, req: _GwRequest) -> None:
        ten = self._tenants[req.tenant]
        ten.queue.remove(req)
        self._pending -= 1

    def _wfq_head_locked(self, shape_key=None) -> Optional[_GwRequest]:
        """The next request in WFQ order: minimum virtual finish tag
        across tenant-queue heads (rank, then rid break ties
        deterministically), optionally restricted to one shape
        bucket."""
        best = None
        for ten in self._tenants.values():
            if not ten.queue:
                continue
            head = ten.queue[0]
            if shape_key is not None and head.shape_key != shape_key:
                continue
            if best is None or (head.vtag, head.rank, head.rid) < \
                    (best.vtag, best.rank, best.rid):
                best = head
        return best

    def _pop_batch_locked(self,
                          seed: Optional[_GwRequest] = None
                          ) -> List[_GwRequest]:
        """Form one batch: WFQ order across tenants, all requests from
        the seed's shape bucket (they pack into one stacked dispatch).
        ``seed`` pins an urgent request that must go NOW, wherever it
        sits in its tenant's FIFO."""
        if seed is not None:
            self._remove_locked(seed)
            self._vtime = max(self._vtime, seed.vtag)
            batch = [seed]
        else:
            head = self._wfq_head_locked()
            if head is None:
                return []
            self._remove_locked(head)
            self._vtime = max(self._vtime, head.vtag)
            batch = [head]
        shape_key = batch[0].shape_key
        while len(batch) < self.max_batch:
            nxt = self._wfq_head_locked(shape_key)
            if nxt is None:
                break
            self._remove_locked(nxt)
            self._vtime = max(self._vtime, nxt.vtag)
            batch.append(nxt)
        return batch

    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop,
                name="legate-sparse-gateway", daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._shutdown and self._pending == 0:
                    self._cv.wait()
                if self._shutdown:
                    return
                now = time.perf_counter_ns()
                oldest = min(t.queue[0].t_ns
                             for t in self._tenants.values()
                             if t.queue)
                wait_s = (oldest + self.timeout_ms * 1e6 - now) / 1e9
                if wait_s > 0:
                    self._cv.wait(wait_s)
                    continue        # re-evaluate after sleep/notify
                batch = self._pop_batch_locked()
            if batch:
                self._dispatch(batch)

    # ---------------- dispatch ----------------

    def _serve_inline(self, req: _GwRequest) -> None:
        """Serve one request through the plain ``A.dot`` dispatch
        (ineligible matrices, fault degradation, fallback) — errors
        resolve THIS request's future only, never a batchmate's."""
        try:
            with _context.use(req.tctx), \
                    _obs.span("gateway.inline", rid=req.rid,
                              tenant=req.tenant, qos=req.qos):
                y = req.A.dot(req.x)
            req.serve(y)
        except BaseException as e:   # noqa: BLE001 - future contract
            req.error(e)

    def _dispatch(self, batch: List[_GwRequest]) -> None:
        with self._dispatch_lock:
            self._dispatch_locked(batch)

    def _dispatch_locked(self, batch: List[_GwRequest]) -> None:
        live = []
        for r in batch:
            if r.deadline is not None and r.deadline.expired():
                # Deadline storm triage at the flush point: expired
                # work buys nothing and displaces on-time requests.
                r.shed("gateway.dispatch", "deadline_shed")
            else:
                live.append(r)
        if not live:
            return
        k = len(live)
        _obs.inc("gateway.dispatches")
        _obs.inc("gateway.dispatched_requests", k)
        _latency.observe("lat.gateway.batch_occupancy", k)
        br = (_rpolicy.breaker("gateway.dispatch")
              if _rsettings.resil else None)
        if _rsettings.resil:
            try:
                _rfaults.fault_point("gateway.dispatch")
            except _rfaults.InjectedFault:
                # Injected dispatch failure: feed the breaker, then
                # serve each request individually through the plain
                # path —
                # a fault drill against one batch must not corrupt or
                # drop any tenant's request.
                if br is not None:
                    br.record_failure()
                _obs.inc("gateway.dispatch_fault_inline")
                for r in live:
                    self._serve_inline(r)
                return
        try:
            with _obs.span("gateway.batch", reqs=k,
                           trace_ids=[r.tctx.trace_id for r in live]
                           ) as sp:
                self._dispatch_engine(live, sp)
        except Exception:
            # Engine-side failure: the gateway inherits the executor's
            # always-safe contract — feed the breaker, serve each
            # unresolved request through the plain dispatch.
            if br is not None:
                br.record_failure()
            _obs.inc("gateway.dispatch_fallback")
            for r in live:
                if not r.future.done():
                    self._serve_inline(r)
        except BaseException as e:   # noqa: BLE001 - deliver, don't die
            for r in live:
                if not r.future.done():
                    r.error(e)
        else:
            if br is not None:
                br.record_success()

    def _dispatch_engine(self, live: List[_GwRequest], sp) -> None:
        groups: Dict[int, List[_GwRequest]] = {}
        order: List[int] = []
        for r in live:
            token = id(r.A)
            if token not in groups:
                groups[token] = []
                order.append(token)
            groups[token].append(r)
        if len(order) > 1:
            # Cross-matrix pack: one stacked dispatch for the whole
            # batch (requests were batch-formed within one shape
            # bucket).  None = the engine declined (int32 segment-id
            # guard) — fall through to per-matrix dispatch.
            ys = self._engine.multi_matvec(
                [(r.A, r.x) for r in live], _checked=True)
            if ys is not None:
                _obs.inc("gateway.packed")
                if sp is not None:
                    sp.set(path="multi", k=len(live))
                for r, y in zip(live, ys):
                    r.serve(y)
                return
        if sp is not None:
            sp.set(path="grouped", k=len(live), groups=len(order))
        for token in order:
            g = groups[token]
            A = g[0].A
            if len(g) == 1:
                # One member: its context tags the dispatch spans.
                with _context.use(g[0].tctx):
                    y = self._engine.matvec(A, g[0].x, _checked=True)
                g[0].serve(y)
            else:
                X = torch.stack([r.x.to(A.dtype) for r in g], dim=1)
                Y = self._engine.matmat(A, X, _checked=True)
                for i, r in enumerate(g):
                    r.serve(Y[:, i])


# ---------------------------------------------------------------- singleton

_gateway: Optional[Gateway] = None
_gateway_lock = threading.Lock()


def get_gateway() -> Gateway:
    """The process-wide gateway over the process engine (created on
    first use)."""
    global _gateway
    if _gateway is None:
        with _gateway_lock:
            if _gateway is None:
                _gateway = Gateway()
    return _gateway


def reset_gateway() -> None:
    """Tear down the process-wide gateway."""
    global _gateway
    with _gateway_lock:
        if _gateway is not None:
            _gateway.shutdown()
        _gateway = None
