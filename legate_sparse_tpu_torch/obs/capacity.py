# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Device-utilization window + advisory capacity report (the port of
``legate_sparse_tpu/obs/capacity.py``).

The second half of the elastic-placement sensor layer
(:mod:`~legate_sparse_tpu_torch.obs.attrib` is the first): a rolling
mesh-slice utilization estimator fed busy time from the tagged
dispatch spans, and a **pure-function** capacity recommendation that
joins three existing signals — per-tenant demand (attributed busy
ns), QoS weight (the gateway's WFQ weights), and SLO burn rate
(``slo.verdicts()``) — into an advisory per-tenant submesh sizing.
It only observes: the recommendation is emitted as a
``capacity.recommendation`` event, and the placement controller
(``legate_sparse_tpu_torch.placement``, whose actuator is the
exactly-priced migration) consumes ``recommend``; nothing here moves
data or resizes anything.

Utilization model
-----------------
Busy time is the summed duration of the attributed dispatch spans
(``gateway.batch`` / ``engine.batch`` — top-level, never nested, so
the sum never double-counts).  The window is a bounded deque of
``(ts_ns, busy_ns, tenant)`` samples; :func:`utilization` reports the
busy fraction of the trailing wall window, optionally divided across
``devices`` slices.  A span times the host's dispatch (no device
sync), and each rank of a job keeps its own window: a rank's busy
fraction is its own card's host-side dispatch share.

Counters (inert-by-default with the attribution ledger)::

    util.busy_ns       total attributed dispatch busy time
    util.dispatches    dispatch spans observed
    capacity.reports   capacity reports emitted

Events::

    capacity.recommendation   one per report: devices, busy_frac and
                              a per-tenant share/devices breakdown

Overhead contract: with ``settings.obs_attrib`` off nothing here is
called (the attrib span hook gates), every public entry returns
immediately on its own flag read, and the window stays empty.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from . import attrib as _attrib
from . import counters as _counters
from . import slo as _slo
from . import trace as _trace
from ..settings import settings as _rsettings

__all__ = [
    "BURN_PAGE", "note_busy", "utilization", "recommend",
    "demand_snapshot", "capacity_report", "reset",
]

#: Fast-window burn at or above this marks a tenant "burning" (the
#: same page threshold the SLO evaluator breaches at).
BURN_PAGE = 14.4

#: Bounded sample window: at bench dispatch rates (~1k/s) this holds
#: well over a minute of samples; eviction is by timestamp anyway.
_MAX_SAMPLES = 8192

_lock = threading.Lock()
# (ts_ns, busy_ns, tenant_label) samples, newest right.
_window: "deque[Tuple[int, int, str]]" = deque(maxlen=_MAX_SAMPLES)


def note_busy(dur_ns: int,
              members: Sequence[Tuple[str, str]]) -> None:
    """Feed one closed dispatch span into the window (called by the
    attrib span hook — already gated on ``settings.obs_attrib``).
    The span's duration is apportioned across its members with the
    declared attrib split rule."""
    now = time.monotonic_ns()
    _counters.handle("util.busy_ns").inc(int(dur_ns))
    _counters.handle("util.dispatches").inc()
    shares = _attrib.apportion(int(dur_ns), members)
    with _lock:
        for (tenant, _qos), share in zip(members, shares):
            if share:
                _window.append((now, share, tenant))


def utilization(window_ms: float = 60_000.0, *,
                devices: int = 1,
                now_ns: Optional[int] = None) -> Dict[str, object]:
    """Busy fraction of the trailing ``window_ms`` wall window, total
    and per tenant.  ``devices`` divides the busy fraction across
    mesh slices (advisory; the host process drives the whole mesh).
    Pure over the window state — no counters move."""
    now = time.monotonic_ns() if now_ns is None else int(now_ns)
    horizon = now - int(window_ms * 1e6)
    busy = 0
    per_tenant: Dict[str, int] = {}
    with _lock:
        while _window and _window[0][0] < horizon:
            _window.popleft()
        for _ts, share, tenant in _window:
            busy += share
            per_tenant[tenant] = per_tenant.get(tenant, 0) + share
    wall = max(1, int(window_ms * 1e6)) * max(1, int(devices))
    return {
        "window_ms": float(window_ms),
        "devices": int(devices),
        "busy_ns": int(busy),
        "busy_frac": min(1.0, busy / wall),
        "per_tenant": per_tenant,
    }


def recommend(demand: Dict[str, Dict[str, object]],
              qos_weights: Dict[str, float],
              burns: Dict[Optional[str], float],
              devices: int) -> Dict[str, object]:
    """PURE advisory submesh sizing from the three sensor signals.

    - ``demand``: ``{tenant: {"busy_ns": int, "qos": str}}`` (reserved
      tenants allowed; they compete for share like any other).
    - ``qos_weights``: WFQ weight per QoS class (unknown classes
      weigh 1.0).
    - ``burns``: fast-window burn per QoS class from the SLO
      evaluator; a tenant whose class burns at page level
      (>= :data:`BURN_PAGE`) is "burning" and rounds UP.
    - ``devices``: total mesh devices to apportion.

    Rule: weighted demand ``busy_ns * weight(qos)`` normalizes to a
    share; every demanding tenant gets at least 1 device; burning
    tenants ceil, others floor; if the total overshoots ``devices``,
    the overshoot is trimmed one device at a time from the largest
    non-burning allocations (ties by tenant name — deterministic).
    The result may still exceed ``devices`` when every tenant is
    burning: that IS the signal the mesh is undersized."""
    devices = max(1, int(devices))
    weighted: Dict[str, float] = {}
    for tenant, d in sorted(demand.items()):
        busy = int(d.get("busy_ns", 0))
        if busy <= 0:
            continue
        weight = float(qos_weights.get(d.get("qos"), 1.0))
        weighted[tenant] = busy * weight
    total_w = sum(weighted.values())
    tenants: Dict[str, Dict[str, object]] = {}
    if total_w > 0:
        for tenant, w in sorted(weighted.items()):
            share = w / total_w
            qos = demand[tenant].get("qos")
            burning = float(burns.get(qos, 0.0)) >= BURN_PAGE
            raw = share * devices
            n = math.ceil(raw) if burning else math.floor(raw)
            tenants[tenant] = {
                "share": share,
                "qos": qos,
                "burning": burning,
                "devices": max(1, int(n)),
            }
        overshoot = sum(t["devices"] for t in tenants.values()) - devices
        if overshoot > 0:
            victims = sorted(
                (t for t, rec in tenants.items()
                 if not rec["burning"] and rec["devices"] > 1),
                key=lambda t: (-tenants[t]["devices"], t))
            for t in victims:
                if overshoot <= 0:
                    break
                take = min(overshoot, tenants[t]["devices"] - 1)
                tenants[t]["devices"] -= take
                overshoot -= take
    allocated = sum(t["devices"] for t in tenants.values())
    return {
        "devices": devices,
        "allocated": allocated,
        "undersized": allocated > devices,
        "tenants": tenants,
    }


def demand_snapshot(*, include_wait: bool = False
                    ) -> Dict[str, Dict[str, object]]:
    """Per-tenant demand from the live attribution ledger —
    ``{tenant: {"busy_ns": int, "qos": str|None}}``, the first input
    of :func:`recommend`.  Busy is the attributed dispatch wall time;
    ``include_wait=True`` adds attributed queue wait (the placement
    controller's choice: wait accrues on every armed gateway request,
    so demand keeps moving even with span tracing off).  QoS is the
    tenant's dominant class (largest ``attrib.op.<tenant>.<qos>.*``
    bucket; None when no tagged dispatch span closed yet)."""
    per_qos: Dict[str, Dict[str, int]] = {}
    for cname, val in _counters.snapshot("attrib.op.").items():
        parts = cname[len("attrib.op."):].split(".")
        if len(parts) < 3:
            continue
        tenant, qos = parts[0], parts[1]
        bucket = per_qos.setdefault(tenant, {})
        bucket[qos] = bucket.get(qos, 0) + int(val)
    demand: Dict[str, Dict[str, object]] = {}
    for tenant, info in _attrib.tenant_snapshot().items():
        busy = int(info.get("wall_ns", 0))
        if include_wait:
            busy += int(info.get("wait_ns", 0))
        if busy <= 0:
            continue
        qos_hist = per_qos.get(tenant, {})
        qos = max(sorted(qos_hist), key=qos_hist.get) if qos_hist \
            else None
        demand[tenant] = {"busy_ns": busy, "qos": qos}
    return demand


def capacity_report(devices: int = 1, *,
                    window_ms: float = 60_000.0) -> Optional[dict]:
    """Join the live sensors into one advisory recommendation, bump
    ``capacity.reports`` and emit the ``capacity.recommendation``
    event.  Returns the recommendation dict (None when attribution is
    off — one flag read)."""
    if not _rsettings.obs_attrib:
        return None
    util = utilization(window_ms, devices=devices)
    demand = demand_snapshot()
    burns: Dict[Optional[str], float] = {}
    for v in _slo.verdicts():
        burns[v.qos] = max(burns.get(v.qos, 0.0), v.fast_burn)
    try:
        from ..engine.gateway import QOS_WEIGHTS as qos_weights
    except Exception:  # pragma: no cover - engine layer unavailable
        qos_weights = {}
    rec = recommend(demand, qos_weights, burns, devices)
    rec["busy_frac"] = util["busy_frac"]
    _counters.handle("capacity.reports").inc()
    _trace.event("capacity.recommendation",
                 devices=rec["devices"], allocated=rec["allocated"],
                 undersized=rec["undersized"],
                 busy_frac=round(float(util["busy_frac"]), 6),
                 tenants=json.dumps(rec["tenants"], sort_keys=True))
    return rec


def reset() -> None:
    """Drop the sample window (test isolation)."""
    with _lock:
        _window.clear()
