# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Opt-in solver health detection at the existing host-sync points (the
port of ``legate_sparse_tpu/resilience/health.py``).

A NaN-producing solve would otherwise return silent garbage: the loop
runs to ``maxiter`` (NaN compares false against the tolerance) and the
caller gets a vector of NaNs with a plausible iteration count.  This
module turns that into a *structured outcome* — site, cause, iterations
completed, partial residual — raised from the convergence fetch the
solver makes anyway (CG fetches its residual beside the convergence
flag there, GMRES its ``[beta, resid]``), so detection adds no host
sync.

Opt-in twice over: requires both ``LEGATE_SPARSE_TPU_RESIL`` (the
subsystem master) and ``LEGATE_SPARSE_TPU_RESIL_HEALTH`` — residual
monitoring changes solver *failure* semantics (raises instead of
returning), which a caller must ask for.

Causes
------
- ``non_finite``   the fetched residual (or cycle-start norm) is NaN
                   or Inf — the classic silent-garbage precursor.
- ``divergence``   residual grew past ``resil_divergence_mult`` x the
                   initial residual.
- ``stagnation``   no relative improvement of the best residual for
                   ``resil_stagnation_cycles`` consecutive
                   observations (0 disables — default).

Each detection increments ``resil.health.<cause>`` and
``resil.health.<site>.<cause>`` and raises :class:`SolverHealthError`
carrying a :class:`..outcomes.HealthReport` plus the partial iterate.
"""

from __future__ import annotations

import math
from typing import Any, Optional

from .. import obs as _obs
from ..settings import settings as _settings
from .outcomes import FinalOutcomeError, HealthReport

# Relative improvement of the best-so-far residual that resets the
# stagnation clock.  Fixed (not a knob): stagnation detection asks "is
# the solver still moving at all", not "is it fast".
STAGNATION_RTOL = 1e-3


class SolverHealthError(FinalOutcomeError):
    """An unhealthy solve, surfaced instead of silent NaNs.

    ``report`` is the structured verdict; ``partial`` the last iterate
    (a tensor on the solve's device, no extra transfer paid)."""

    def __init__(self, report: HealthReport, partial: Any = None):
        self.report = report
        self.partial = partial
        super().__init__(
            f"solver health: {report.cause} at {report.site} after "
            f"{report.iterations} iterations"
            + (f" (residual {report.residual:.3e})"
               if isinstance(report.residual, float)
               and math.isfinite(report.residual) else
               f" (residual {report.residual})"
               if report.residual is not None else ""))


def active() -> bool:
    """Health detection on? (master switch AND the health opt-in)."""
    return bool(_settings.resil and _settings.resil_health)


def _raise(site: str, cause: str, iterations: int,
           residual: Optional[float], partial: Any,
           detail: str = "") -> None:
    _obs.inc(f"resil.health.{cause}")
    _obs.inc(f"resil.health.{site}.{cause}")
    _obs.event("resil.health", site=site, cause=cause,
               iterations=iterations, residual=residual)
    raise SolverHealthError(
        HealthReport(site=site, cause=cause, iterations=int(iterations),
                     residual=residual, detail=detail),
        partial=partial)


class Monitor:
    """Per-solve residual monitor fed at each host-sync point.

    Construct once per solve; ``observe(residual, iterations,
    partial)`` at every convergence fetch.  No-op (two attribute
    reads) when health detection is off."""

    def __init__(self, site: str):
        self.site = site
        self._initial: Optional[float] = None
        self._best = math.inf
        self._since_best = 0

    def observe(self, residual: float, iterations: int,
                partial: Any = None) -> None:
        if not active():
            return
        r = float(residual)
        if not math.isfinite(r):
            _raise(self.site, "non_finite", iterations, r, partial)
        if self._initial is None:
            self._initial = r
        mult = float(_settings.resil_divergence_mult)
        if mult > 0 and r > mult * max(self._initial, 1e-300):
            _raise(self.site, "divergence", iterations, r, partial,
                   detail=f"initial={self._initial:.3e}")
        cycles = int(_settings.resil_stagnation_cycles)
        if cycles > 0:
            if r < self._best * (1.0 - STAGNATION_RTOL):
                self._best = r
                self._since_best = 0
            else:
                self._since_best += 1
                if self._since_best >= cycles:
                    _raise(self.site, "stagnation", iterations, r,
                           partial,
                           detail=f"best={self._best:.3e} for "
                                  f"{self._since_best} cycles")
