# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""SLO-driven placement controller (the port of
``legate_sparse_tpu/placement/controller.py``, docs/PLACEMENT.md).

The decision half of the loop, split along the same purity seam as
``capacity.recommend``:

- :func:`propose` is a **pure function of its snapshot** — no clock,
  no counter, no settings read inside (pinned by
  tests/test_torch_placement.py the same way ``recommend``'s purity is
  pinned).  It sizes via
  ``capacity.recommend``, clamps + carves via ``placement.submesh``,
  prices every move via the ``reshard_volumes`` predictor, and only
  proposes action when the predicted saving amortizes the priced cost
  — unless a tenant's QoS class is burning at page level (the breach
  is already the expensive outcome) or the gateway flagged it for a
  breaker-degraded shrink.
- :class:`PlacementController` owns everything impure: gathering the
  snapshot from the live sensors (attribution demand, SLO burn
  verdicts, the registry's current slices), the monotonic-clock
  cooldown/hysteresis that keeps the loop from flapping, migration
  execution through the registry, thrash detection, and the optional
  watchdog thread (mirroring ``obs/slo.py``).

SPMD agreement: each rank's attribution ledger holds only its own load,
so on a job of several ranks :meth:`PlacementController.step` joins the
ranks' local snapshots by one ``all_gather_object`` over the whole job
before proposing: per-tenant demand summed over the ranks (its QoS the
class of the rank that saw the most of it, ties by name), burns the
ranks' maximum per class, shrink flags their union, and the clock
reading rank 0's.  Every rank then proposes and applies the same moves,
and the cooldown and thrash window read one clock, so the ranks cannot
disagree on an epoch boundary.  The watchdog thread steps one process
alone: on a job of several ranks it does not start (a collective from a
thread of one rank would hang the others); call :meth:`step` from every
rank instead.

Amortization model (docs/PLACEMENT.md): priced bytes convert to cost
time at the assumed migration bandwidth (``1 GB/s == 1 byte/ns``, so
``cost_ns = bytes / bw_gbps``); predicted saving is the ideal-scaling
``busy_ns * (1 - eff_src / eff_dst)`` summed over growing tenants; an
efficiency-driven plan executes only when
``saving >= amortize * cost``.

Counters / events / histograms (docs/OBSERVABILITY.md):

- ``placement.steps`` / ``placement.proposals`` /
  ``placement.hold.<reason>`` / ``placement.thrash`` /
  ``placement.watchdog.ticks``
- events ``placement.plan`` / ``placement.hold`` /
  ``placement.thrash``
- histogram ``lat.placement.step``
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

from ..obs import capacity as _capacity
from ..obs import counters as _counters
from ..obs import latency as _latency
from ..obs import slo as _slo
from ..obs import trace as _trace
from ..settings import settings as _rsettings
from . import migrate as _migrate
from . import submesh as _submesh

__all__ = [
    "PlacementSnapshot", "PlacementDecision", "propose",
    "PlacementController", "agree",
]

#: Fast-window burn at/above this marks a move SLO-driven (same page
#: threshold as capacity.BURN_PAGE / the SLO evaluator).
BURN_PAGE = _capacity.BURN_PAGE


class PlacementSnapshot(NamedTuple):
    """Everything :func:`propose` is allowed to know — gathered once
    per step by the controller, consumed pure."""

    demand: Dict[str, Dict[str, object]]     # tenant -> busy_ns/qos
    qos_weights: Dict[str, float]
    burns: Dict[Optional[str], float]        # qos -> fast burn
    devices: int
    current: Dict[str, Tuple[int, int]]      # placed tenant -> slice
    payload_bytes: Dict[str, int]            # registered tenants
    shrink: Tuple[str, ...]                  # breaker-flagged tenants


class PlacementDecision(NamedTuple):
    """One proposal: the full target carve, the subset that must
    move, and the amortization verdict."""

    act: bool
    reason: str          # migrate reasons: shrink/burning/amortized;
    #                      hold reasons: steady/no_demand/unamortized/
    #                      cooldown (the last applied by step())
    allocation: Dict[str, int]
    slices: Dict[str, Tuple[int, int]]
    moves: Dict[str, Tuple[int, int]]
    priced_bytes: Dict[str, int]
    total_priced_bytes: int
    predicted_saving_ns: float
    priced_cost_ns: float


def propose(snap: PlacementSnapshot, *, bw_gbps: float = 10.0,
            amortize: float = 1.0) -> PlacementDecision:
    """PURE placement proposal from one sensor snapshot (module
    docstring for the model; no clock/counter/settings reads — pinned
    by test)."""
    rec = _capacity.recommend(snap.demand, snap.qos_weights,
                              snap.burns, snap.devices)
    allocation = _submesh.feasible_allocation(rec, snap.devices)
    # Placed tenants with no demand this window keep their slice: the
    # carve must keep covering them or neighbors would land on their
    # devices.
    for tenant, (_, count) in sorted(snap.current.items()):
        allocation.setdefault(tenant, count)
    # Breaker-degraded shrink: halve the flagged tenant's slice
    # relative to today (floor 1) regardless of what demand says.
    for tenant in snap.shrink:
        cur = snap.current.get(tenant)
        if cur is None:
            continue
        target = max(1, cur[1] // 2)
        allocation[tenant] = min(allocation.get(tenant, target), target)
    if not allocation:
        return PlacementDecision(
            act=False, reason="no_demand", allocation={}, slices={},
            moves={}, priced_bytes={}, total_priced_bytes=0,
            predicted_saving_ns=0.0, priced_cost_ns=0.0)
    overshoot = sum(allocation.values()) - snap.devices
    if overshoot > 0:
        # The keep-your-slice / shrink adjustments can re-overflow a
        # clamped allocation; re-trim with the same deterministic rule.
        allocation = _submesh.feasible_allocation(
            {"tenants": {t: {"devices": n, "share": 0.0}
                         for t, n in allocation.items()}},
            snap.devices)
    slices = _submesh.carve(allocation, snap.devices)
    # Only registered tenants (payload known) can migrate; everything
    # else is advisory sizing with nothing to move.
    moves = {t: sl for t, sl in slices.items()
             if t in snap.payload_bytes and snap.current.get(t) != sl}
    if not moves:
        return PlacementDecision(
            act=False, reason="steady", allocation=allocation,
            slices=slices, moves={}, priced_bytes={},
            total_priced_bytes=0, predicted_saving_ns=0.0,
            priced_cost_ns=0.0)
    priced = {t: _submesh.priced_bytes(
        _submesh.price_migration(snap.payload_bytes[t], sl[1]))
        for t, sl in moves.items()}
    total_bytes = sum(priced.values())
    cost_ns = total_bytes / max(1e-9, float(bw_gbps))
    demanders = max(1, len(snap.demand))
    saving_ns = 0.0
    burning = False
    for t, sl in moves.items():
        d = snap.demand.get(t, {})
        eff_src = _submesh.effective_devices(
            snap.current.get(t), snap.devices, demanders)
        saving_ns += _submesh.predicted_saving_ns(
            int(d.get("busy_ns", 0)), eff_src, float(sl[1]))
        if float(snap.burns.get(d.get("qos"), 0.0)) >= BURN_PAGE:
            burning = True
    if any(t in snap.shrink for t in moves):
        act, reason = True, "shrink"
    elif burning:
        # A page-level burn is already the expensive outcome;
        # amortization gates only efficiency-driven moves.
        act, reason = True, "burning"
    elif saving_ns >= float(amortize) * cost_ns:
        act, reason = True, "amortized"
    else:
        act, reason = False, "unamortized"
    return PlacementDecision(
        act=act, reason=reason, allocation=allocation, slices=slices,
        moves=moves, priced_bytes=priced,
        total_priced_bytes=total_bytes,
        predicted_saving_ns=saving_ns, priced_cost_ns=cost_ns)


def agree(snap: PlacementSnapshot, now_ns: int
          ) -> Tuple[PlacementSnapshot, int]:
    """The job's snapshot and clock reading from every rank's local
    ones: one ``all_gather_object`` over the whole job (identity in a
    process of its own).  Demand sums per tenant over the ranks, its QoS
    taken from the rank with the largest share (ties by class name);
    burns take each class's maximum, shrink flags their union; the
    registry's slices and payloads, the weights, the device count and
    the clock are rank 0's (the registry is equal on every rank)."""
    if len(_submesh.job_ranks()) <= 1:
        return snap, int(now_ns)
    import torch.distributed as dist

    parts: list = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (snap, int(now_ns)))
    demand: Dict[str, Dict[str, object]] = {}
    top: Dict[str, Tuple[int, str]] = {}
    burns: Dict[Optional[str], float] = {}
    shrink: set = set()
    for part, _ in parts:
        for tenant, d in part.demand.items():
            busy = int(d.get("busy_ns", 0))
            qos = d.get("qos")
            agg = demand.setdefault(tenant, {"busy_ns": 0, "qos": qos})
            agg["busy_ns"] = int(agg["busy_ns"]) + busy
            key = (busy, "" if qos is None else str(qos))
            if tenant not in top or key > top[tenant]:
                top[tenant] = key
                agg["qos"] = qos
        for qos, burn in part.burns.items():
            burns[qos] = max(burns.get(qos, 0.0), float(burn))
        shrink.update(part.shrink)
    first, now0 = parts[0]
    return first._replace(
        demand={t: demand[t] for t in sorted(demand)}, burns=burns,
        shrink=tuple(sorted(shrink))), int(now0)


class PlacementController:
    """Epoch-driven control loop: explicit :meth:`step` plus an
    optional monotonic-clock watchdog.  One flag read and nothing
    else while ``settings.placement`` is off."""

    def __init__(self, *, devices: Optional[Sequence] = None,
                 cooldown_ms: Optional[float] = None,
                 bw_gbps: Optional[float] = None,
                 amortize: Optional[float] = None):
        if devices is None:
            devices = _submesh.job_ranks()
        self._devices = list(devices)
        self.cooldown_ms = float(
            _rsettings.placement_cooldown_ms if cooldown_ms is None
            else cooldown_ms)
        self.bw_gbps = float(
            _rsettings.placement_bw_gbps if bw_gbps is None
            else bw_gbps)
        self.amortize = float(
            _rsettings.placement_amortize if amortize is None
            else amortize)
        self._lock = threading.Lock()
        self._last_migration_ns: Optional[int] = None
        # tenant -> (migration ts_ns, its class's fast burn then):
        # the thrash detector's memory.
        self._tenant_last: Dict[str, Tuple[int, float]] = {}
        self._watchdog_thread: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()

    # ---------------- sensor gather (impure) ----------------

    def snapshot(self) -> PlacementSnapshot:
        """Join the live sensors into one immutable snapshot: demand
        from the attribution ledger (wall + queue wait, so demand
        moves even with tracing off), burns from the last SLO
        evaluation, slices/payloads/flags from the registry."""
        demand = _capacity.demand_snapshot(include_wait=True)
        from ..obs import attrib as _attrib

        for reserved in (_attrib.UNTAGGED, _attrib.OTHER):
            demand.pop(reserved, None)
        burns: Dict[Optional[str], float] = {}
        for v in _slo.verdicts():
            burns[v.qos] = max(burns.get(v.qos, 0.0), v.fast_burn)
        try:
            from ..engine.gateway import QOS_WEIGHTS as qos_weights
        except Exception:  # pragma: no cover - engine unavailable
            qos_weights = {}
        reg = _migrate.registry()
        return PlacementSnapshot(
            demand=demand, qos_weights=dict(qos_weights), burns=burns,
            devices=len(self._devices), current=reg.slices(),
            payload_bytes=reg.payload_bytes(),
            shrink=reg.shrink_flagged())

    # ---------------- the loop ----------------

    def step(self, now_ns: Optional[int] = None
             ) -> Optional[PlacementDecision]:
        """One control epoch: snapshot -> agree -> propose -> (maybe)
        migrate.  On a job of several ranks every rank calls it (the
        agreement is a collective of the job).
        Cooldown/hysteresis: an actionable plan inside
        ``cooldown_ms`` of the last executed migration is held
        (reason ``cooldown``) — except breaker-driven shrinks, which
        are about containment, not efficiency.  Returns the decision
        (``None`` while placement is off — one flag read)."""
        if not _rsettings.placement:
            return None
        t0 = time.perf_counter_ns()
        _counters.inc("placement.steps")
        snap, now = agree(self.snapshot(),
                          time.monotonic_ns() if now_ns is None
                          else int(now_ns))
        decision = propose(snap, bw_gbps=self.bw_gbps,
                           amortize=self.amortize)
        _counters.inc("placement.proposals")
        _trace.event(
            "placement.plan", act=decision.act, reason=decision.reason,
            allocation=json.dumps(decision.allocation, sort_keys=True),
            priced_bytes=decision.total_priced_bytes,
            saving_ns=round(decision.predicted_saving_ns, 1),
            cost_ns=round(decision.priced_cost_ns, 1))
        if decision.act:
            with self._lock:
                last = self._last_migration_ns
            cooled = (last is not None and decision.reason != "shrink"
                      and now - last < self.cooldown_ms * 1e6)
            if cooled:
                decision = decision._replace(act=False,
                                             reason="cooldown")
        if decision.act:
            _migrate.registry().apply(decision.moves, self._devices)
            with self._lock:
                self._last_migration_ns = now
                for t in decision.moves:
                    burn = float(snap.burns.get(
                        snap.demand.get(t, {}).get("qos"), 0.0))
                    prev = self._tenant_last.get(t)
                    if (prev is not None
                            and now - prev[0] < self.cooldown_ms * 1e6
                            and burn >= prev[1] > 0.0):
                        # Same tenant re-migrated within its cooldown
                        # window while its class burns no less than at
                        # the previous move: the loop is thrashing,
                        # not converging (doctor: migration-thrash).
                        _counters.inc("placement.thrash")
                        _trace.event("placement.thrash", tenant=t,
                                     burn=round(burn, 3),
                                     prev_burn=round(prev[1], 3))
                    self._tenant_last[t] = (now, burn)
        else:
            _counters.inc(f"placement.hold.{decision.reason}")
            _trace.event("placement.hold", reason=decision.reason)
        _latency.observe("lat.placement.step",
                         (time.perf_counter_ns() - t0) / 1e6)
        return decision

    # ---------------- watchdog (mirrors obs/slo.py) ----------------

    def start_watchdog(self, interval_ms: Optional[float] = None
                       ) -> bool:
        """Start the daemon stepping thread on a monotonic-clock
        cadence (``Event.wait`` never goes backwards with wall-clock
        steps).  Returns True when (already) running; no-op unless
        armed and the interval is positive, and on a job of several
        ranks (module docstring)."""
        if not _rsettings.placement or len(_submesh.job_ranks()) > 1:
            return False
        if interval_ms is None:
            interval_ms = _rsettings.placement_watchdog_ms
        if interval_ms <= 0:
            return False
        with self._lock:
            if (self._watchdog_thread is not None
                    and self._watchdog_thread.is_alive()):
                return True
            self._watchdog_stop.clear()
            interval_s = float(interval_ms) / 1e3

            def _loop():
                while not self._watchdog_stop.wait(interval_s):
                    try:
                        _counters.inc("placement.watchdog.ticks")
                        self.step()
                    except Exception:  # pragma: no cover - never kill
                        pass

            self._watchdog_thread = threading.Thread(
                target=_loop, name="lst-placement-watchdog",
                daemon=True)
            self._watchdog_thread.start()
        return True

    def stop_watchdog(self) -> None:
        t = self._watchdog_thread
        if t is None:
            return
        self._watchdog_stop.set()
        t.join(timeout=5.0)
        self._watchdog_thread = None

    def maybe_start_watchdog(self) -> bool:
        """Arm the watchdog from settings alone."""
        return self.start_watchdog()
