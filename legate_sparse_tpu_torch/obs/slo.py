# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Declarative SLOs over the always-on latency histograms (the port of
``legate_sparse_tpu/obs/slo.py``).

The gateway records per-QoS wait/latency distributions and the
executor per-request latencies — but "is the fleet burning its latency
budget" was still a human reading latency tables.  This
module is the machine answer: a registry of per-(op, QoS) latency
objectives with error budgets, evaluated as **multi-window burn
rates** over rebased snapshots of the existing ``lat.*`` histograms
(``obs/latency.py``) — no new measurement path, no new locks on any
hot path.

Burn-rate model (the SRE multi-window form, discretized onto the
evaluation cadence):

- the **fast window** is the histogram delta since the previous
  ``evaluate()`` call (bucket-wise subtraction of the last snapshot —
  the same rebased-snapshot scheme the histograms themselves use);
- the **slow window** is the lifetime accumulation since the last
  ``slo.reset()``;
- per window, ``bad`` = observations above the objective (bucket
  upper bound > objective, so the documented ~4.4% bucket relative
  error never misclassifies a clearly-good bucket), and
  ``burn = (bad/total) / (1 - target)`` — burn 1.0 means exactly
  spending the error budget, 14.4 the classic page-now threshold.

A verdict is ``breach`` when the fast window burns at or above
``fast_burn`` (with at least ``min_events`` observations — empty
windows never page), ``watch`` when only the slow window is at or
above ``slow_burn``, else ``ok``.  Breaches increment the **exact**
counter ``slo.breach.<slo>`` and emit a ``slo.verdict`` event (when
tracing is on), so drills can assert equality, not ``>=``.

The fast-window baselines are per process: on a job, each rank
evaluates its own histograms.

Evaluation runs at scrape/export points (``obs.snapshot_openmetrics``
calls :func:`evaluate` first) and from an optional monotonic-clock
watchdog thread.  **Inert by default**: without
``LEGATE_SPARSE_TPU_OBS_SLO`` the evaluator is one flag read returning
``[]``, no ``slo.*`` counter ever moves, and the watchdog never starts
— bit-for-bit the pre-v4 process, pinned by test.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

from . import counters as _counters
from . import latency as _latency
from . import trace as _trace
from ..settings import settings as _rsettings

__all__ = [
    "Slo", "SloVerdict", "register", "registered", "evaluate",
    "verdicts", "start_watchdog", "stop_watchdog",
    "maybe_start_watchdog", "reset",
]


@dataclass(frozen=True)
class Slo:
    """One latency objective: ``target`` fraction of ``op`` requests
    (for ``qos``, when the op is QoS-classed) must complete within
    ``objective_ms``.  ``hist_prefix`` names the ``lat.*`` histogram
    family the objective is measured against."""

    name: str                   # registry key, e.g. "gateway.interactive"
    op: str                     # e.g. "gateway.request"
    qos: Optional[str]          # QoS class, None for un-classed ops
    hist_prefix: str            # e.g. "lat.gateway.request.interactive"
    objective_ms: float
    target: float = 0.999      # good fraction; budget = 1 - target
    fast_burn: float = 14.4    # breach threshold, fast window
    slow_burn: float = 1.0     # watch threshold, slow window
    min_events: int = 1        # fast-window floor below which no breach

    @property
    def budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


class SloVerdict(NamedTuple):
    """One evaluation result.  ``status`` ∈ ok / watch / breach."""

    slo: str
    op: str
    qos: Optional[str]
    status: str
    objective_ms: float
    target: float
    fast_total: int
    fast_bad: int
    fast_burn: float
    slow_total: int
    slow_bad: int
    slow_burn: float


# Default fleet objectives: one per gateway QoS class (tightest for
# interactive, loosest for background — mirroring the WFQ weights) and
# one for the bare executor.  ``register()`` overrides by name.
DEFAULT_SLOS = (
    Slo("gateway.interactive", "gateway.request", "interactive",
        "lat.gateway.request.interactive", objective_ms=50.0,
        target=0.999),
    Slo("gateway.batch", "gateway.request", "batch",
        "lat.gateway.request.batch", objective_ms=250.0, target=0.99),
    Slo("gateway.background", "gateway.request", "background",
        "lat.gateway.request.background", objective_ms=1000.0,
        target=0.95),
    Slo("engine.request", "engine.request", None,
        "lat.engine.request.", objective_ms=250.0, target=0.99),
    # Graph analytics: whole-algorithm wall objectives over
    # the always-on lat.graph.<alg> histograms — loose targets, these
    # are batch traversals, not interactive serving.
    Slo("graph.bfs", "graph.bfs", None, "lat.graph.bfs",
        objective_ms=1000.0, target=0.95),
    Slo("graph.sssp", "graph.sssp", None, "lat.graph.sssp",
        objective_ms=2000.0, target=0.95),
    Slo("graph.cc", "graph.cc", None, "lat.graph.cc",
        objective_ms=2000.0, target=0.95),
    Slo("graph.pagerank", "graph.pagerank", None, "lat.graph.pagerank",
        objective_ms=5000.0, target=0.95),
)

_lock = threading.Lock()
_registry: Dict[str, Slo] = {s.name: s for s in DEFAULT_SLOS}
# Per-SLO fast-window baseline: (counts list, sum) of the merged
# histogram at the previous evaluation.
_baselines: Dict[str, List[int]] = {}
_last_verdicts: List[SloVerdict] = []


def register(slo: Slo) -> None:
    """Add (or replace, by name) an objective."""
    with _lock:
        _registry[slo.name] = slo
        _baselines.pop(slo.name, None)


def registered() -> List[Slo]:
    with _lock:
        return [_registry[k] for k in sorted(_registry)]


def _merged_counts(prefix: str) -> List[int]:
    """Bucket counts of all ``lat.*`` histograms under ``prefix``,
    merged (shape-bucketed families fold into one distribution)."""
    counts = [0] * _latency._NSLOTS
    for hist in _latency.snapshot(prefix).values():
        for slot, c in enumerate(hist.counts):
            counts[slot] += c
    return counts


def _bad_total(counts: List[int], objective_ms: float):
    """(bad, total) observations: a bucket is bad when even its upper
    bound exceeds the objective."""
    bad = total = 0
    for slot, c in enumerate(counts):
        if not c:
            continue
        total += c
        if _latency.slot_upper(slot) > objective_ms * (1 + 1e-9):
            bad += c
    return bad, total


def evaluate() -> List[SloVerdict]:
    """Evaluate every registered SLO against the live histograms.
    Inert (``[]``, zero counter movement) unless
    ``settings.obs_slo`` — the scrape path calls this unconditionally."""
    if not _rsettings.obs_slo:
        return []
    _counters.inc("slo.evaluations")
    out: List[SloVerdict] = []
    with _lock:
        slos = [_registry[k] for k in sorted(_registry)]
        for slo in slos:
            counts = _merged_counts(slo.hist_prefix)
            base = _baselines.get(slo.name)
            if base is None:
                fast = counts
            else:
                # External ``latency.reset()`` rebases live histograms
                # below our baseline — clamp, never count negative.
                fast = [max(0, c - b) for c, b in zip(counts, base)]
            _baselines[slo.name] = counts
            fast_bad, fast_total = _bad_total(fast, slo.objective_ms)
            slow_bad, slow_total = _bad_total(counts, slo.objective_ms)
            fast_burn = ((fast_bad / fast_total) / slo.budget
                         if fast_total else 0.0)
            slow_burn = ((slow_bad / slow_total) / slo.budget
                         if slow_total else 0.0)
            if fast_total >= slo.min_events and \
                    fast_burn >= slo.fast_burn:
                status = "breach"
            elif slow_total and slow_burn >= slo.slow_burn:
                status = "watch"
            else:
                status = "ok"
            out.append(SloVerdict(
                slo=slo.name, op=slo.op, qos=slo.qos, status=status,
                objective_ms=slo.objective_ms, target=slo.target,
                fast_total=fast_total, fast_bad=fast_bad,
                fast_burn=fast_burn, slow_total=slow_total,
                slow_bad=slow_bad, slow_burn=slow_burn))
        _last_verdicts[:] = out
    # Counter/event emission outside the registry lock: the exact-by-
    # contract breach ledger plus a structured verdict record per
    # non-ok SLO (events are no-ops while tracing is off).
    for v in out:
        if v.status == "breach":
            _counters.inc(f"slo.breach.{v.slo}")
        if v.status != "ok":
            _trace.event("slo.verdict", slo=v.slo, status=v.status,
                         objective_ms=v.objective_ms,
                         fast_bad=v.fast_bad, fast_total=v.fast_total,
                         fast_burn=round(v.fast_burn, 3),
                         slow_bad=v.slow_bad, slow_total=v.slow_total,
                         slow_burn=round(v.slow_burn, 3))
    return out


def verdicts() -> List[SloVerdict]:
    """The most recent evaluation's verdicts (empty before the first
    armed evaluation)."""
    with _lock:
        return list(_last_verdicts)


# ------------------------------------------------------------ watchdog --
_watchdog_thread: Optional[threading.Thread] = None
_watchdog_stop = threading.Event()


def start_watchdog(interval_ms: Optional[float] = None) -> bool:
    """Start the daemon evaluation thread on a monotonic-clock cadence
    (``Event.wait`` never goes backwards with wall-clock steps).
    Returns True when (already) running; no-op unless armed and the
    interval is positive."""
    global _watchdog_thread
    if not _rsettings.obs_slo:
        return False
    if interval_ms is None:
        interval_ms = _rsettings.obs_slo_watchdog_ms
    if interval_ms <= 0:
        return False
    with _lock:
        if _watchdog_thread is not None and _watchdog_thread.is_alive():
            return True
        _watchdog_stop.clear()
        interval_s = interval_ms / 1e3

        def _loop():
            while not _watchdog_stop.wait(interval_s):
                try:
                    _counters.inc("slo.watchdog.ticks")
                    evaluate()
                except Exception:   # pragma: no cover - never kill host
                    pass

        _watchdog_thread = threading.Thread(
            target=_loop, name="lst-slo-watchdog", daemon=True)
        _watchdog_thread.start()
    return True


def stop_watchdog() -> None:
    global _watchdog_thread
    t = _watchdog_thread
    if t is None:
        return
    _watchdog_stop.set()
    t.join(timeout=5.0)
    _watchdog_thread = None


def maybe_start_watchdog() -> bool:
    """Arm the watchdog from settings alone (call sites that want the
    env-driven behavior without importing settings)."""
    return start_watchdog()


def reset() -> None:
    """Test isolation: stop the watchdog, drop window baselines and
    verdicts, restore the default registry."""
    stop_watchdog()
    with _lock:
        _registry.clear()
        _registry.update({s.name: s for s in DEFAULT_SLOS})
        _baselines.clear()
        _last_verdicts.clear()
