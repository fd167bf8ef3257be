# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Typed outcomes of the resilience layer (the port of
``legate_sparse_tpu/resilience/outcomes.py``, plain Python).

A failure the layer could not absorb never surfaces as a silent NaN
result, a dropped request, or a hang — it surfaces as one of these
types, each carrying enough structure (site, iterations completed,
partial residual/result) for the caller to decide between degrading,
re-queueing, and reporting.

- :class:`Rejected` — a request shed *before* dispatch (expired
  deadline at the executor's admission or flush point).  It is a
  **value**, not an exception: the executor resolves the request's
  Future with it, because for serving traffic "not done, and here is
  why" is a normal response, not a crash.
- :class:`DeadlineExceeded` — a solve cut off *mid-flight* at one of
  its host-sync points.  Raised, because the caller asked for a
  converged solution and is not getting one; the exception carries the
  partial iterate so a caller with laxer requirements can still use
  it.
- :class:`ChecksumError` — an ABFT checksum mismatch of a distributed
  SpMV: retryable, so the ``dist.spmv`` site re-dispatches it.
- :class:`HealthReport` — the structured verdict an unhealthy solve
  raises with (``health.SolverHealthError``).
- :class:`ResilienceError` — base class of every exception this layer
  raises (``policy.CircuitOpenError`` included), so one ``except``
  clause covers the whole contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class ResilienceError(RuntimeError):
    """Base class of every exception the resilience layer raises."""


class FinalOutcomeError(ResilienceError):
    """A resilience *verdict* (deadline expired, health failure, open
    breaker) as opposed to a retryable fault: ``policy.run`` re-raises
    these immediately — retrying a deadline expiry would re-run a
    whole solve past its deadline, and a verdict is not a site
    failure, so it never feeds the breaker either."""


#: Closed vocabulary of shed/reject causes.  ``deadline_shed`` — the
#: request's deadline expired (at admission, flush, or a deadline
#: storm eviction); ``quota`` — the tenant's token bucket ran dry;
#: ``queue_full`` — a per-tenant queue quota or the global pending
#: bound was hit (including backpressure eviction of a queued
#: victim); ``breaker`` — shed during a breaker-open degraded window.
REJECT_REASONS = ("deadline_shed", "quota", "queue_full", "breaker")


@dataclass(frozen=True)
class Rejected:
    """A request shed before dispatch (typed outcome, not an error).

    ``site`` is the shedding point (``engine.exec.queue`` for
    admission, ``engine.exec.dispatch`` for a flush-time shed,
    ``gateway.admit`` / ``gateway.dispatch`` for the multi-tenant
    gateway), ``reason`` one of :data:`REJECT_REASONS`,
    ``waited_ms`` how long the request sat in the queue before the
    shed decision, ``deadline_ms`` the budget it arrived with, and
    ``tenant`` the owning tenant when shed by the gateway.

    The older spelling ``reason="deadline"`` normalizes to
    ``deadline_shed``; any string outside the vocabulary fails loudly
    at construction."""

    site: str
    reason: str = "deadline_shed"
    waited_ms: float = 0.0
    deadline_ms: Optional[float] = None
    tenant: Optional[str] = None

    def __post_init__(self) -> None:
        if self.reason == "deadline":        # legacy spelling
            object.__setattr__(self, "reason", "deadline_shed")
        if self.reason not in REJECT_REASONS:
            raise ValueError(
                f"Rejected.reason={self.reason!r}: expected one of "
                f"{REJECT_REASONS}")


class DeadlineExceeded(FinalOutcomeError):
    """A solve ran out of deadline at a host-sync point.

    ``iterations`` is the count completed when the deadline check
    fired, ``residual`` the last observed residual norm (None when the
    site had not fetched one yet), ``partial`` the best iterate so far
    (a device array — no extra transfer was paid to raise this)."""

    def __init__(self, site: str, iterations: int = 0,
                 residual: Optional[float] = None,
                 partial: Any = None):
        self.site = site
        self.iterations = int(iterations)
        self.residual = residual
        self.partial = partial
        super().__init__(
            f"deadline exceeded at {site} after {iterations} "
            f"iterations"
            + (f" (residual {residual:.3e})"
               if isinstance(residual, float) else ""))


class DeviceLost(FinalOutcomeError):
    """A mesh device vanished mid-solve (detected at a host-sync
    point — the conv-fetch cadence is the only place a distributed
    solve touches the host, so it is also where loss is observed).

    A final outcome, not a retryable fault: retrying the same dispatch
    on the same (now smaller) device set would fail identically, and
    feeding the breaker would poison the site for the *recovered*
    mesh.  ``policy.run`` re-raises immediately; the recovery ladder
    in ``dist_cg`` / ``dist_gmres`` catches it, shrinks the mesh to
    the survivor grid, reshards, restores the last checkpoint, and
    resumes (``parallel/dist_csr.py::_solve_with_recovery``)."""

    def __init__(self, site: str, ordinal: int = 0,
                 device: int = 0):
        self.site = site
        self.ordinal = int(ordinal)
        self.device = int(device)
        super().__init__(
            f"device {device} lost at {site} (ordinal {ordinal})")


class ChecksumError(ResilienceError):
    """An ABFT checksum mismatch: the y-checksum of a distributed SpMV
    disagreed with the column-checksum prediction, i.e. a collective
    (or the kernel feeding it) corrupted data in flight.  Retryable —
    ``policy.run`` at the ``dist.spmv`` site re-dispatches the SpMV,
    which recomputes from the (intact) operands — unlike the final
    verdicts above."""

    def __init__(self, site: str, observed: float, expected: float):
        self.site = site
        self.observed = float(observed)
        self.expected = float(expected)
        super().__init__(
            f"ABFT checksum mismatch at {site}: observed "
            f"{observed!r}, expected {expected!r}")


@dataclass(frozen=True)
class HealthReport:
    """Structured description of an unhealthy solve (see
    ``health.SolverHealthError``): which sync point saw it, why
    (``non_finite`` / ``stagnation`` / ``divergence``), how far the
    solve got, and the residual that triggered the verdict."""

    site: str
    cause: str
    iterations: int
    residual: Optional[float] = None
    detail: str = ""
    extra: dict = field(default_factory=dict)
