# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Deterministic, seedable fault injection at named sites (the port of
``legate_sparse_tpu/resilience/faults.py``).

Every instrumented dispatch point calls

    fault_point("engine.exec.dispatch")     # error / latency sites
    y = fault_point("csr.dot", y)           # value sites

which is one flag read while the subsystem is off
(``LEGATE_SPARSE_TPU_RESIL`` unset) and consults the armed-fault table
when it is on.  Tests and the chip drill arm faults with :func:`inject`;
drills are deterministic ("fail calls 1..count, then succeed"), and
optionally probabilistic through a seeded LCG (no global RNG state).

Site names form a closed catalog (:data:`CATALOG`, the JAX package's
whole catalog), and every site has a call in the port: the ``engine.*``,
``csr.dot`` and ``gateway.*`` sites on the serving path, the ``dist.*``
sites in ``parallel/``, the ``solver.*`` sites at the solvers'
convergence fetches and ``delta.compact`` in the delta layer
(``tests/test_torch_resilience_solvers.py`` holds the catalog to the
source).  A ``fault_point`` with an unknown name raises while the
subsystem is on.

Kinds
-----
- ``error``     raise :class:`InjectedFault` (retry/breaker drills)
- ``latency``   ``time.sleep(latency_ms)`` before proceeding (deadline
                and shedding drills)
- ``nonfinite`` poison the tensor flowing through a value site (its
                last element set to NaN); a site without a floating
                tensor treats it as a no-op fire
- ``device_loss`` raise :class:`~.outcomes.DeviceLost` carrying the
                armed device ordinal

Capture safety: injection is suppressed while a CUDA graph is being
captured or ``torch.compile`` is tracing (``resil.fault.trace_skipped``):
a fault fired there would be baked into the captured program and
replayed forever.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .. import obs as _obs
from ..settings import settings as _settings
from .outcomes import DeviceLost, ResilienceError

#: The closed site catalog: every ``fault_point`` names one of these
#: (the JAX package's catalog, whole).
CATALOG: Dict[str, str] = {
    "engine.plan.build":
        "engine/plan_cache.py: AOT plan compile (XLA lower+compile)",
    "engine.exec.queue":
        "engine/executor.py: request admission into the micro-batch "
        "queue",
    "engine.exec.dispatch":
        "engine/core.py: bucketed plan dispatch (matvec/matmat)",
    "csr.dot":
        "csr.py: csr_array.dot SpMV/SpMM/SpGEMM dispatch",
    "dist.spmv":
        "parallel/dist_csr.py: distributed SpMV collective dispatch",
    "dist.spmv.abft":
        "parallel/dist_csr.py: ABFT y-checksum verification of an "
        "eager distributed SpMV (value site carrying y — arm "
        "nonfinite to drill a corrupted collective)",
    "dist.cg":
        "parallel/dist_csr.py: dist_cg solve dispatch (collective "
        "loop)",
    "dist.spgemm":
        "parallel/dist_spgemm.py: distributed SpGEMM phases",
    "solver.cg.conv":
        "linalg.py: CG chunked convergence fetch (one per "
        "conv_test_iters cycle)",
    "solver.gmres.conv":
        "linalg.py: GMRES per-restart-cycle convergence fetch",
    "gateway.admit":
        "engine/gateway.py: multi-tenant admission (quota / token "
        "bucket / deadline triage)",
    "gateway.dispatch":
        "engine/gateway.py: WFQ batch dispatch (stacked multi-matrix "
        "or per-matrix plan execution)",
    "delta.compact":
        "delta/core.py: background compaction merge (side-buffer -> "
        "fresh base CSR) before the atomic version swap",
}

#: Fault kinds a site can be armed with.
KINDS = ("error", "latency", "nonfinite", "device_loss")


class InjectedFault(ResilienceError):
    """The exception an ``error``-kind armed site raises."""

    def __init__(self, site: str, ordinal: int):
        self.site = site
        self.ordinal = ordinal
        super().__init__(f"injected fault #{ordinal} at {site}")


@dataclass
class _Arm:
    site: str
    kind: str
    count: int
    after: int
    latency_ms: float
    p: float
    seed: int
    calls: int = 0
    fired: int = 0
    meta: dict = field(default_factory=dict)


_lock = threading.Lock()
_arms: Dict[str, _Arm] = {}


def inject(site: str, kind: str = "error", count: int = 1,
           after: int = 0, latency_ms: float = 5.0, p: float = 1.0,
           seed: int = 0, device: int = 0) -> None:
    """Arm ``site`` to fire ``kind`` on its next ``count`` eligible
    calls (skipping the first ``after``).  ``p < 1`` makes each
    eligible call fire with probability ``p`` drawn from a
    deterministic per-call LCG over ``seed`` — same seed, same
    schedule, every run.  ``device`` names the flat mesh ordinal a
    ``device_loss`` fire reports as lost (ignored by other kinds)."""
    if site not in CATALOG:
        raise ValueError(
            f"unknown fault site {site!r}; catalog: {sorted(CATALOG)}")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
    with _lock:
        _arms[site] = _Arm(site=site, kind=kind, count=int(count),
                           after=int(after),
                           latency_ms=float(latency_ms), p=float(p),
                           seed=int(seed),
                           meta={"device": int(device)})


def clear(site: Optional[str] = None) -> None:
    """Disarm one site, or every site."""
    with _lock:
        if site is None:
            _arms.clear()
        else:
            _arms.pop(site, None)


def armed(site: Optional[str] = None):
    """Snapshot of the armed table (one site, or all): ``{site:
    {kind, count, fired, calls}}``."""
    with _lock:
        items = ([_arms[site]] if site is not None and site in _arms
                 else (list(_arms.values()) if site is None else []))
        return {a.site: {"kind": a.kind, "count": a.count,
                         "fired": a.fired, "calls": a.calls}
                for a in items}


def fired(site: str) -> int:
    """How many times ``site``'s armed fault has fired."""
    with _lock:
        a = _arms.get(site)
        return a.fired if a is not None else 0


def _trace_clean() -> bool:
    """True when neither a CUDA graph capture nor a ``torch.compile``
    trace is under way on this thread."""
    import torch

    if torch.compiler.is_compiling():
        return False
    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


def _lcg01(seed: int, n: int) -> float:
    """Deterministic per-call uniform in [0, 1): one 64-bit LCG step
    over (seed, call ordinal) — no global RNG state touched."""
    x = (seed * 6364136223846793005 + n * 1442695040888963407
         + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
    x = (x * 6364136223846793005 + 1) & 0xFFFFFFFFFFFFFFFF
    return (x >> 11) / float(1 << 53)


def _poison(value: Any) -> Any:
    """``value`` with its LAST element set to NaN (a copy), when it is
    a floating or complex tensor; anything else (the ``csr_array`` an
    SpGEMM returns) passes unchanged, so the fire is a no-op rather
    than an error the retry ladder would misread as a site failure."""
    import torch

    if not isinstance(value, torch.Tensor) or not (
            value.is_floating_point() or value.is_complex()):
        return value
    out = value.clone()
    if out.numel():
        out.view(-1)[-1] = float("nan")
    return out


def fault_point(site: str, value: Any = None) -> Any:
    """The per-site injection hook (see module docstring).

    Returns ``value`` unchanged on the overwhelmingly common path; an
    armed ``error`` fault raises :class:`InjectedFault`, ``latency``
    sleeps, ``nonfinite`` returns a poisoned copy of ``value``."""
    if not _settings.resil:
        return value
    if site not in CATALOG:
        raise ValueError(
            f"fault_point({site!r}): site not in catalog")
    # Unlocked emptiness/get probes are GIL-atomic dict reads: the
    # zero-arm common case takes no lock, and the hit path re-reads
    # under the lock below before acting.
    if not _arms:
        return value
    arm = _arms.get(site)
    if arm is None:
        return value
    if not _trace_clean():
        _obs.inc("resil.fault.trace_skipped")
        return value
    with _lock:
        # Re-read under the lock (clear() may have raced the fast path).
        arm = _arms.get(site)
        if arm is None:
            return value
        arm.calls += 1
        fire = (arm.calls > arm.after and arm.fired < arm.count
                and (arm.p >= 1.0
                     or _lcg01(arm.seed, arm.calls) < arm.p))
        if fire:
            arm.fired += 1
            ordinal = arm.fired
            kind = arm.kind
            latency_ms = arm.latency_ms
            device = int(arm.meta.get("device", 0))
    if not fire:
        return value
    _obs.inc("resil.fault.injected")
    _obs.inc(f"resil.fault.{site}.injected")
    _obs.event("resil.fault", site=site, kind=kind, ordinal=ordinal)
    if kind == "error":
        raise InjectedFault(site, ordinal)
    if kind == "device_loss":
        raise DeviceLost(site, ordinal, device)
    if kind == "latency":
        if latency_ms > 0:
            time.sleep(latency_ms / 1e3)
        return value
    # nonfinite
    if value is None:
        return None
    return _poison(value)
