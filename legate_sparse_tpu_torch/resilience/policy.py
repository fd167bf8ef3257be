# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Per-site retry ladders, retry budgets, and circuit breakers (the port
of ``legate_sparse_tpu/resilience/policy.py``).

One function is the whole integration surface::

    y = policy.run("engine.exec.dispatch", attempt, fallback=plain)

``run`` executes ``attempt`` under the site's policy:

- **retry with deterministic exponential backoff** — up to
  ``settings.resil_retries`` re-executions, sleeping
  ``backoff_ms * mult**attempt`` (clamped at ``backoff_max_ms``)
  between them.  The schedule is deterministic (no jitter): drills
  assert exact counter accounting, and a single-tenant accelerator
  queue gains nothing from decorrelation.
- **retry budgets** — a per-site, per-process budget
  (``settings.resil_retry_budget``) bounds total retry amplification:
  a persistently failing hot loop degrades to fail-fast instead of
  multiplying its own load by ``1 + retries``.
- **circuit breaker** — ``closed -> open`` after K *consecutive*
  failures (``settings.resil_breaker_k``), ``open -> half_open`` after
  ``resil_breaker_cooldown_ms``, where exactly one probe call is let
  through: success closes the breaker, failure re-opens it.  While
  open, ``run`` short-circuits to ``fallback`` — for the engine
  dispatch site that *flips the existing ladder* (engine -> the plain
  ``csr_array.dot`` dispatch) instead of hammering a broken
  rung — or raises :class:`CircuitOpenError` when the site has no
  cheaper rung (fail fast IS the load-shedding behavior there).

Counters (always exact — drills assert equality, not >=):
``resil.retry.attempts`` / ``resil.retry.<site>`` /
``resil.retry.backoff_ms`` / ``resil.retry.exhausted`` /
``resil.retry.budget_exhausted``; ``resil.breaker.trips`` /
``resil.breaker.<site>.trips`` / ``.short_circuit`` / ``.half_open`` /
``.close``; ``resil.fallback`` / ``resil.fallback.<site>``.

With ``settings.resil`` off, ``run`` is ``fn()`` behind one flag read.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type

from .. import obs as _obs
from ..settings import settings as _settings
from .outcomes import FinalOutcomeError


class CircuitOpenError(FinalOutcomeError):
    """Raised by ``run`` when the site's breaker is open and no
    fallback rung exists — the typed fast-fail."""

    def __init__(self, site: str):
        self.site = site
        super().__init__(f"circuit breaker open for {site}")


class CircuitBreaker:
    """Closed / open / half-open breaker over consecutive failures.

    ``allow()`` answers "may this call proceed?" and performs the
    open -> half-open transition (electing exactly one probe);
    ``record_success`` / ``record_failure`` feed outcomes back."""

    def __init__(self, site: str, k: int, cooldown_s: float):
        self.site = site
        self.k = max(int(k), 1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        # Cooldown arithmetic on integer monotonic_ns (clock-step
        # safe; the source is read via the ``time`` module attribute
        # at call time so tests can freeze it).
        self.cooldown_ns = int(self.cooldown_s * 1e9)
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at_ns = 0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == "closed":
                return True
            now_ns = time.monotonic_ns()
            if self._state == "open":
                if now_ns - self._opened_at_ns < self.cooldown_ns:
                    return False
                self._state = "half_open"
                self._probing = True
                _obs.inc("resil.breaker.half_open")
                _obs.event("resil.breaker", site=self.site,
                           to="half_open")
                return True          # this caller is the probe
            # half_open: one probe in flight at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            # Any non-closed -> closed transition is a close in the
            # ledger (a concurrent trip can land between this call's
            # attempt and its feedback, so the open state is reachable
            # here too — the counter contract is exact either way).
            if self._state != "closed":
                _obs.inc("resil.breaker.close")
                _obs.event("resil.breaker", site=self.site, to="closed")
            self._state = "closed"
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._trip_locked(reopen=True)
                return
            if self._state == "open":
                return
            self._failures += 1
            if self._failures >= self.k:
                self._trip_locked(reopen=False)

    def _trip_locked(self, reopen: bool) -> None:
        self._state = "open"
        self._opened_at_ns = time.monotonic_ns()
        self._failures = 0
        self._probing = False
        _obs.inc("resil.breaker.trips")
        _obs.inc(f"resil.breaker.{self.site}.trips")
        _obs.event("resil.breaker", site=self.site, to="open",
                   reopen=reopen)

    def release_probe(self) -> None:
        """Give back a half-open probe slot without a verdict.

        The probe call may end in a resilience *verdict*
        (``FinalOutcomeError``: deadline expiry, inner open breaker)
        that says nothing about this site's health — neither success
        nor failure.  Without this release the slot would stay taken
        and the breaker would wedge in half-open forever (no
        time-based exit from that state)."""
        with self._lock:
            if self._state == "half_open":
                self._probing = False

    def reset(self) -> None:
        with self._lock:
            self._state = "closed"
            self._failures = 0
            self._probing = False


_registry_lock = threading.Lock()
_breakers: Dict[str, CircuitBreaker] = {}
_budgets: Dict[str, int] = {}


def breaker(site: str) -> CircuitBreaker:
    """The site's breaker (created from the live settings knobs on
    first use)."""
    # Unlocked .get is a GIL-atomic dict read on the hot path; a miss
    # falls through to the locked double-checked create below.
    br = _breakers.get(site)
    if br is not None:
        return br
    with _registry_lock:
        br = _breakers.get(site)
        if br is None:
            br = _breakers[site] = CircuitBreaker(
                site, _settings.resil_breaker_k,
                _settings.resil_breaker_cooldown_ms / 1e3)
        return br


def _take_budget(site: str) -> bool:
    """Consume one unit of the site's retry budget; False when dry."""
    with _registry_lock:
        left = _budgets.get(site)
        if left is None:
            left = max(int(_settings.resil_retry_budget), 0)
        if left <= 0:
            _budgets[site] = 0
            return False
        _budgets[site] = left - 1
        return True


def reset() -> None:
    """Drop every breaker and refill every budget (tests / bench
    phases; live traffic never needs this)."""
    with _registry_lock:
        _breakers.clear()
        _budgets.clear()


def run(site: str, fn: Callable, fallback: Optional[Callable] = None,
        retryable: Tuple[Type[BaseException], ...] = (Exception,)):
    """Execute ``fn`` under ``site``'s retry/breaker policy (module
    docstring).  ``fallback`` is invoked (once, unretried) when the
    breaker is open or retries are exhausted; without one the last
    error (or :class:`CircuitOpenError`) propagates."""
    if not _settings.resil:
        return fn()
    br = breaker(site)
    if not br.allow():
        _obs.inc("resil.breaker.short_circuit")
        _obs.inc(f"resil.breaker.{site}.short_circuit")
        if fallback is not None:
            _obs.inc("resil.fallback")
            _obs.inc(f"resil.fallback.{site}")
            return fallback()
        raise CircuitOpenError(site)
    retries = max(int(_settings.resil_retries), 0)
    attempt = 0
    while True:
        try:
            out = fn()
        except FinalOutcomeError:
            # A verdict from a nested resilience layer (deadline
            # expiry, health failure, open inner breaker) is not a
            # site failure: no retry, no breaker feedback, no
            # fallback masking — it IS the answer.  If this call held
            # the half-open probe slot, give it back (a verdict is
            # not a probe outcome).
            br.release_probe()
            raise
        except retryable:
            br.record_failure()
            # Re-consult the breaker BEFORE another attempt: this
            # call's own failures may just have tripped it, and a
            # tripped site must not keep getting hammered from inside
            # the retry loop (allow() may instead elect this attempt
            # as the half-open probe, whose success/failure feedback
            # the normal paths handle).
            if attempt < retries and br.allow():
                if not _take_budget(site):
                    _obs.inc("resil.retry.budget_exhausted")
                else:
                    delay_ms = min(
                        _settings.resil_backoff_ms
                        * (_settings.resil_backoff_mult ** attempt),
                        _settings.resil_backoff_max_ms)
                    _obs.inc("resil.retry.attempts")
                    _obs.inc(f"resil.retry.{site}")
                    _obs.inc("resil.retry.backoff_ms", delay_ms)
                    if delay_ms > 0:
                        time.sleep(delay_ms / 1e3)
                    attempt += 1
                    continue
            _obs.inc("resil.retry.exhausted")
            if fallback is not None:
                _obs.inc("resil.fallback")
                _obs.inc(f"resil.fallback.{site}")
                return fallback()
            raise
        except BaseException:
            # Non-Exception escapes (KeyboardInterrupt, SystemExit)
            # bypass the retryable clause entirely — release a held
            # probe slot so the breaker cannot wedge in half-open.
            br.release_probe()
            raise
        else:
            br.record_success()
            return out
