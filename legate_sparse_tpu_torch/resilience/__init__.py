# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""legate_sparse_tpu_torch.resilience: the failure layer (the port of
``legate_sparse_tpu/resilience``).

Failures are injectable, bounded and observable:

- ``faults``     — deterministic, seedable fault injection at a closed
                   catalog of named sites (``fault_point("dist.spmv")``),
                   wired through the engine, ``csr_array.dot``, the
                   gateway, the distributed products and solvers, the
                   solvers' convergence fetches and the delta layer's
                   compaction;
- ``policy``     — per-site retry with deterministic exponential
                   backoff, retry budgets, and circuit breakers whose
                   trip flips the fallback ladder (engine -> plain
                   dispatch);
- ``deadline``   — request deadlines carried in contextvars; the
                   executor and the gateway shed expired requests with
                   a typed ``Rejected`` outcome, the solvers check at
                   their convergence fetches and raise
                   ``DeadlineExceeded`` with the partial iterate;
- ``health``     — opt-in non-finite/divergence/stagnation detection at
                   the same fetches, raised as ``SolverHealthError``
                   with a ``HealthReport`` instead of silent NaNs;
- ``checkpoint`` — restartable solver snapshots in host memory at the
                   same cadence; the recovery ladder of ``dist_cg`` /
                   ``dist_gmres`` restores the last one after a
                   ``DeviceLost`` and resumes on the survivor mesh;
- ``outcomes``   — the typed outcome and error vocabulary;
- ``chaos``      — the composed-fault drill: random faults from the
                   catalog under live multi-tenant gateway load, with
                   exactly-once, exact-accounting and bitwise-parity
                   invariants, and the device-loss and mutation
                   scenarios.

Inert by default: with ``LEGATE_SPARSE_TPU_RESIL`` unset every hook is
one flag read, no site adds a host sync, and behaviour is exactly that
of the package without the layer.  Every retry, breaker transition,
shed request, injected fault, snapshot and recovery lands in
``resil.*`` obs counters and events.
"""

from __future__ import annotations

from . import (  # noqa: F401
    chaos, checkpoint, deadline, faults, health, outcomes, policy,
)
from .checkpoint import SolverCheckpoint  # noqa: F401
from .faults import CATALOG, InjectedFault, fault_point, inject  # noqa: F401
from .health import Monitor, SolverHealthError  # noqa: F401
from .outcomes import (  # noqa: F401
    ChecksumError, DeadlineExceeded, DeviceLost, FinalOutcomeError,
    HealthReport, Rejected, ResilienceError,
)
from .policy import CircuitOpenError, breaker, run  # noqa: F401
from ..settings import settings as _settings

__all__ = [
    "chaos", "checkpoint", "deadline", "faults", "health", "outcomes",
    "policy",
    "SolverCheckpoint",
    "CATALOG", "InjectedFault", "fault_point", "inject",
    "Monitor", "SolverHealthError",
    "ChecksumError", "DeadlineExceeded", "DeviceLost",
    "FinalOutcomeError", "HealthReport", "Rejected",
    "ResilienceError",
    "CircuitOpenError", "breaker", "run",
    "active", "guarded_call", "reset",
]


def active() -> bool:
    """The subsystem master switch (``settings.resil``) — the one flag
    every instrumented site reads first."""
    return bool(_settings.resil)


def guarded_call(site: str, fn, fallback=None):
    """The standard site wrap: ``fault_point(site)`` then ``fn()``,
    under ``policy.run``'s retry/breaker ladder — so an injected (or
    real) failure at the site is retried with backoff and accounted
    per site.  Call only when :func:`active` (callers keep their
    zero-overhead fast path explicit)."""
    def attempt():
        faults.fault_point(site)
        return fn()

    return policy.run(site, attempt, fallback=fallback)


def reset() -> None:
    """Disarm all faults, reset breakers, refill retry budgets."""
    faults.clear()
    policy.reset()
