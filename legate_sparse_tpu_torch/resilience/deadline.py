# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Deadline propagation: request budgets that ride the call stack (the
port of ``legate_sparse_tpu/resilience/deadline.py``).

A serving request that can no longer meet its deadline is *negative*
work: it occupies queue slots and device time that on-time requests
need.  This module carries the deadline down the stack as a
``contextvars`` scope so the layers below can shed:

    with deadline.scope(250.0):          # 250 ms budget
        fut = engine.submit(A, x)        # queue wait counts against it
        x, iters = linalg.cg(A, b)       # checked each conv cycle

- The **executor** captures ``deadline.current()`` at submit time (the
  submitting thread's scope — the worker thread dispatching later
  still sheds against the *request's* deadline, not its own) and sheds
  expired requests with a typed :class:`..outcomes.Rejected` Future
  result instead of dispatching them.
- The **solvers** check the deadline at their convergence cadence
  (``raise_if_expired``: CG before each stretch of ``conv_test_iters``
  iterations, GMRES before each restart cycle, ``refine=`` at each
  refinement fetch) and raise :class:`..outcomes.DeadlineExceeded`
  with the partial iterate; the check adds no host sync.

Nested scopes compose by *sooner wins*: an inner ``scope(1000)``
under an outer 50 ms budget still expires at the outer deadline.
Scopes are inert without ``LEGATE_SPARSE_TPU_RESIL`` — the instrumented
sites read the flag before consulting the contextvar.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass
from typing import Iterator, Optional

from .. import obs as _obs
from .outcomes import DeadlineExceeded
from .outcomes import Rejected  # noqa: F401  (re-export convenience)


@dataclass(frozen=True)
class Deadline:
    """An absolute expiry on the monotonic clock plus the budget it
    was created with (for reporting).

    Expiry arithmetic is integer ``time.monotonic_ns()`` — never wall
    clock (NTP steps would expire or resurrect budgets), and never
    float seconds (whose 2^53 mantissa silently coarsens long-uptime
    monotonic readings below the sub-ms budgets used here).  The
    clock source is read through the ``time`` module attribute at
    every call so tests can freeze/step it with ``monkeypatch``."""

    t_end_ns: int           # time.monotonic_ns() expiry
    total_ms: float

    def remaining_ms(self) -> float:
        return (self.t_end_ns - time.monotonic_ns()) / 1e6

    def expired(self) -> bool:
        return time.monotonic_ns() >= self.t_end_ns


_var: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "legate_sparse_tpu_torch_resil_deadline", default=None)


@contextlib.contextmanager
def scope(ms: float) -> Iterator[Deadline]:
    """Bind a deadline ``ms`` milliseconds from now for the enclosed
    code (sooner-wins under nesting)."""
    d = Deadline(time.monotonic_ns() + int(float(ms) * 1e6), float(ms))
    cur = _var.get()
    if cur is not None and cur.t_end_ns < d.t_end_ns:
        d = cur
    token = _var.set(d)
    try:
        yield d
    finally:
        _var.reset(token)


def current() -> Optional[Deadline]:
    """The innermost active deadline, or None."""
    return _var.get()


def remaining_ms() -> Optional[float]:
    """Milliseconds left on the active deadline (None without one)."""
    d = _var.get()
    return None if d is None else d.remaining_ms()


def expired() -> bool:
    """True iff a deadline is active AND has passed."""
    d = _var.get()
    return d is not None and d.expired()


def raise_if_expired(site: str, iterations: int = 0,
                     residual: Optional[float] = None,
                     partial=None) -> None:
    """The shared solver-side enforcement point: when the active
    deadline has passed, account it (``resil.deadline.solver`` +
    per-site counter, ``resil.deadline`` event) and raise
    :class:`DeadlineExceeded` carrying the solve's progress.  Checked
    BEFORE each cycle dispatch, so an expired budget buys no further
    device work.  No-op without an active, expired deadline."""
    d = _var.get()
    if d is None or not d.expired():
        return
    expire(site, iterations, residual, partial)


def expire(site: str, iterations: int = 0,
           residual: Optional[float] = None, partial=None) -> None:
    """Account an expired deadline at ``site`` and raise
    :class:`DeadlineExceeded` (``raise_if_expired``'s verdict; a
    distributed solve calls it on every rank once the ranks agree that
    the deadline has passed)."""
    _obs.inc("resil.deadline.solver")
    _obs.inc(f"resil.deadline.{site}")
    _obs.event("resil.deadline", site=site, iterations=iterations,
               residual=residual)
    raise DeadlineExceeded(site, iterations=iterations,
                           residual=residual, partial=partial)
