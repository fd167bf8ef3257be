# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""legate_sparse_tpu_torch.resilience: the request half of the failure
layer (the port of ``legate_sparse_tpu/resilience``).

Failures on the serving path are injectable, bounded and observable:

- ``faults``   — deterministic, seedable fault injection at a closed
                 catalog of named sites (``fault_point("csr.dot")``),
                 wired through the engine, ``csr_array.dot`` and the
                 gateway;
- ``policy``   — per-site retry with deterministic exponential backoff,
                 retry budgets, and circuit breakers whose trip flips
                 the fallback ladder (engine -> plain dispatch);
- ``deadline`` — request deadlines carried in contextvars; the executor
                 and the gateway shed expired requests with a typed
                 ``Rejected`` outcome;
- ``outcomes`` — the typed outcome and error vocabulary.

The JAX package's ``health``, ``checkpoint`` and ``chaos`` modules, and
the solver and distribution sites, wait for a later slice.

Inert by default: with ``LEGATE_SPARSE_TPU_RESIL`` unset every hook is
one flag read and behaviour is exactly that of the package without the
layer.  Every retry, breaker transition, shed request and injected
fault lands in ``resil.*`` obs counters and events.
"""

from __future__ import annotations

from . import deadline, faults, outcomes, policy  # noqa: F401
from .faults import CATALOG, InjectedFault, fault_point, inject  # noqa: F401
from .outcomes import (  # noqa: F401
    DeadlineExceeded, DeviceLost, FinalOutcomeError, Rejected,
    ResilienceError,
)
from .policy import CircuitOpenError, breaker, run  # noqa: F401

__all__ = [
    "deadline", "faults", "outcomes", "policy",
    "CATALOG", "InjectedFault", "fault_point", "inject",
    "DeadlineExceeded", "DeviceLost", "FinalOutcomeError", "Rejected",
    "ResilienceError",
    "CircuitOpenError", "breaker", "run",
    "reset",
]


def reset() -> None:
    """Disarm all faults, reset breakers, refill retry budgets."""
    faults.clear()
    policy.reset()
