# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Per-tenant resource attribution ledger (the port of
``legate_sparse_tpu/obs/attrib.py``, under its names and split rule).

The gateway counts per-tenant *requests*
(``gateway.tenant.<t>.submitted/served/shed``) but device-time,
communication bytes, memory watermarks, and compile cost were pool-wide
aggregates — no controller could answer "which tenant is consuming the
mesh".  This module is the sensor: it rides the existing
:class:`~legate_sparse_tpu_torch.obs.context.TraceContext` (extended to carry
``tenant``/``qos``, minted at ``Gateway.submit`` and carried across
executor workers exactly like trace ids) and attributes, at span close
and comm-ledger record time, wall time, ``comm.*`` bytes,
dispatch/compile counts, and ``mem.*`` watermark deltas to
``(tenant, qos, op)``.

Apportioning rule (declared, deterministic)
-------------------------------------------
Packed multi-tenant batches (``gateway.batch`` over ``multi_matvec`` /
grouped ``matmat``, ``engine.batch`` over a stacked operand) dispatch
ONE device program for K member requests.  Costs are integers (bytes;
wall time in integer ns) and are split **by member request count**:
every member gets ``total // K``; the remainder ``total % K`` is handed
out one unit at a time to members in ascending ``(tenant, qos,
position)`` order.  Integer apportioning means per-tenant sums conserve
EXACTLY against the untagged totals:

- ``sum_t attrib.tenant.<t>.comm_bytes == attrib.total.comm_bytes``,
  and both equal the ``comm.total_bytes`` delta over the attributed
  window (the bytes hook fires inside :func:`comm.record` under the
  same gating as ``comm.total_bytes``);
- ``sum_t attrib.tenant.<t>.wall_ns == attrib.total.wall_ns`` — equal
  to the summed duration of the attributed dispatch spans.

SPMD: every rank keeps its own ledger of its own spans and its own
wire bytes, so conservation holds on each rank against that rank's
``comm.total_*``; a job-wide view sums the ranks' ledgers (the
placement controller agrees its demand that way).

Work with no tenant (direct engine calls, maintenance traffic) is
attributed to the reserved ``__untagged__`` tenant rather than dropped,
so conservation holds for the whole process, not just gateway traffic.

What is attributed where
------------------------
- **bytes / collective calls** — :func:`on_comm`, called by
  ``comm.record``; active whenever ``settings.obs_attrib`` is on
  (needs no tracing).
- **wall time / dispatch + compile counts** — :func:`on_span_close`,
  called by ``trace`` when a span in :data:`DISPATCH_SPANS` closes
  (``gateway.batch`` / ``engine.batch``: the top-level dispatch busy
  spans, never nested in each other).  Spans only exist while tracing
  is on (``LEGATE_SPARSE_TPU_OBS=1``), so wall attribution rides the
  same switch.  A first-call span (compile) bumps ``compiles``.
- **gateway/executor wait** — :func:`on_wait` from the request finish
  paths: every outcome attributes its queue wait, so shed/errored
  requests show up with wait but zero dispatch cost.
- **memory watermark deltas** — :func:`on_mem` from
  ``memory.watermark.__exit__`` (positive RSS growth only, KiB —
  counters are monotone).

Tenant-label cardinality is bounded: :func:`tenant_label` sanitizes
names to a dot-free safe charset and, past
``settings.obs_tenant_cap`` distinct tenants (default 64,
``LEGATE_SPARSE_TPU_OBS_TENANT_CAP``), folds overflow into the
reserved ``__other__`` label, so counter families and OpenMetrics
label sets cannot grow without bound.

Counters (all under ``attrib.``, inert-by-default —
``LEGATE_SPARSE_TPU_OBS_ATTRIB``)::

    attrib.tenant.<tenant>.comm_bytes   attributed interconnect bytes
    attrib.tenant.<tenant>.comm_calls   attributed collective ops
    attrib.tenant.<tenant>.wall_ns      attributed dispatch busy time
    attrib.tenant.<tenant>.wait_ns      attributed queue wait
    attrib.tenant.<tenant>.dispatches   dispatch spans (apportioned
                                        member count)
    attrib.tenant.<tenant>.compiles     first-call dispatch spans
    attrib.tenant.<tenant>.mem_kb       watermark RSS growth
    attrib.op.<tenant>.<qos>.<op>.ns    per-(tenant, qos, op) wall ns
    attrib.total.*                      untagged totals, bumped at the
                                        same hook sites (conservation)
    attrib.fold.other                   tenant-cap folds performed

Overhead contract: with ``settings.obs_attrib`` off every hook is one
attribute read and a return — no counters move, no labels intern, and
results are bit-for-bit identical (nothing here touches dispatch
math).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

from . import context as _context
from . import counters as _counters
from ..settings import settings as _rsettings

__all__ = [
    "UNTAGGED", "OTHER", "DISPATCH_SPANS", "enabled", "tenant_label",
    "scope", "current_members", "apportion", "on_comm",
    "on_span_close", "on_wait", "on_mem", "tenant_snapshot", "reset",
]

#: Reserved sink for work with no tenant context (conservation).
UNTAGGED = "__untagged__"
#: Reserved fold target once the tenant-label cap is reached.
OTHER = "__other__"
_RESERVED = (UNTAGGED, OTHER)

#: The dispatch busy-span set: top-level spans whose duration is
#: attributed as device time.  ``gateway.batch`` and ``engine.batch``
#: are never nested inside each other (the gateway dispatches the
#: engine facade directly, not through the executor), and
#: ``gateway.inline`` (the gateway's single-request plain dispatch:
#: ineligible matrices — including placed-tenant handles — and
#: fault/breaker degradation) never runs inside either, so summing
#: their durations never double-counts.
DISPATCH_SPANS = frozenset({"gateway.batch", "engine.batch",
                            "gateway.inline"})

# (tenant, qos) member list of the active packed batch, if any; set by
# the gateway/executor dispatch paths around multi-member dispatches.
# A scope wins over the single-request TraceContext.
_scope_var: "contextvars.ContextVar[Optional[Tuple[Tuple[str, str], ...]]]" = \
    contextvars.ContextVar("legate_sparse_tpu_torch_attrib_scope", default=None)

# Distinct non-reserved tenant labels seen (cardinality cap state).
_lock = threading.Lock()
_seen: set = set()

_SAFE = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-")


def enabled() -> bool:
    """One settings read: the whole-subsystem switch."""
    return _rsettings.obs_attrib


def tenant_label(raw: Optional[str]) -> str:
    """Sanitized, cardinality-capped counter label for a tenant name.

    Characters outside ``[A-Za-z0-9_-]`` (including ``.``, quotes,
    newlines, arbitrary unicode) map to ``_`` so labels are dot-free
    (counter names stay parseable) and OpenMetrics-safe before the
    exporter's own escaping even runs; labels truncate at 64 chars.
    Past ``settings.obs_tenant_cap`` distinct labels, new ones fold to
    ``__other__``.  Reserved labels pass through and never count
    toward the cap."""
    if not raw:
        return UNTAGGED
    raw = str(raw)
    if raw in _RESERVED:
        return raw
    label = "".join(c if c in _SAFE else "_" for c in raw[:64])
    if not label.strip("_"):
        # Fully mangled (e.g. all-unicode name): keep a stable
        # non-empty stand-in rather than colliding with reserved names.
        label = f"t{len(label)}" if label else "t0"
    with _lock:
        if label in _seen:
            return label
        if len(_seen) >= max(1, int(_rsettings.obs_tenant_cap)):
            _counters.handle("attrib.fold.other").inc()
            return OTHER
        _seen.add(label)
        return label


def _qos_label(qos: Optional[str]) -> str:
    if not qos:
        return "none"
    return "".join(c if c in _SAFE else "_" for c in str(qos)[:32])


@contextlib.contextmanager
def scope(members: Sequence[Tuple[Optional[str], Optional[str]]]
          ) -> Iterator[None]:
    """Declare the ``(tenant, qos)`` members of a packed multi-member
    dispatch for the body: every hook fired inside apportions its cost
    across these members (the declared split rule).  Wins over the
    single-request TraceContext.  No-op (and allocation-free beyond
    the contextvar set) when attribution is off or ``members`` is
    empty."""
    if not _rsettings.obs_attrib or not members:
        yield
        return
    resolved = tuple((tenant_label(t), _qos_label(q)) for t, q in members)
    token = _scope_var.set(resolved)
    try:
        yield
    finally:
        _scope_var.reset(token)


def current_members() -> Tuple[Tuple[str, str], ...]:
    """The members the next cost attributes to: the active scope's,
    else the active TraceContext's ``(tenant, qos)``, else
    ``__untagged__``."""
    sc = _scope_var.get()
    if sc:
        return sc
    ctx = _context.current()
    if ctx is not None and getattr(ctx, "tenant", None):
        return ((tenant_label(ctx.tenant), _qos_label(ctx.qos)),)
    return ((UNTAGGED, "none"),)


def apportion(total: int, members: Sequence[Tuple[str, str]]
              ) -> List[int]:
    """Split integer ``total`` across ``members`` by request count:
    ``total // K`` each, remainder one unit at a time in ascending
    ``(tenant, qos, position)`` order.  Deterministic, and
    ``sum(result) == total`` exactly."""
    k = len(members)
    total = int(total)
    base, rem = divmod(total, k)
    shares = [base] * k
    if rem:
        order = sorted(range(k), key=lambda i: (members[i], i))
        for i in order[:rem]:
            shares[i] += 1
    return shares


def _attribute(kind: str, total: int,
               members: Optional[Sequence[Tuple[str, str]]] = None
               ) -> None:
    """Apportion ``total`` integer units of ``kind`` across the active
    members and bump the per-tenant + untagged-total counters at the
    same site (the conservation invariant is by construction)."""
    total = int(total)
    if total <= 0:
        return
    if members is None:
        members = current_members()
    for (tenant, _qos), share in zip(members,
                                     apportion(total, members)):
        if share:
            _counters.handle(f"attrib.tenant.{tenant}.{kind}").inc(share)
    _counters.handle(f"attrib.total.{kind}").inc(total)


# ---------------------------------------------------------------- hooks --
def on_comm(op: str, total_bytes: int, total_calls: int) -> None:
    """``comm.record`` hook: attribute one distributed dispatch's
    predicted interconnect bytes and collective-op count.  Fires under
    the exact gating of ``comm.total_bytes`` (non-zero dispatches
    only), so attributed sums conserve against it exactly."""
    if not _rsettings.obs_attrib:
        return
    members = current_members()
    _attribute("comm_bytes", total_bytes, members)
    _attribute("comm_calls", total_calls, members)


def on_span_close(name: str, dur_ns: int, first: bool) -> None:
    """Span-close hook (from ``trace``): attribute a dispatch span's
    wall time, dispatch count, and compile (first-call) count.  Only
    spans in :data:`DISPATCH_SPANS` are device-time; everything else
    returns immediately."""
    if not _rsettings.obs_attrib or name not in DISPATCH_SPANS:
        return
    members = current_members()
    _attribute("wall_ns", dur_ns, members)
    _attribute("dispatches", len(members), members)
    if first:
        _attribute("compiles", len(members), members)
    for (tenant, qos), share in zip(members,
                                    apportion(int(dur_ns), members)):
        if share:
            _counters.handle(
                f"attrib.op.{tenant}.{qos}.{name}.ns").inc(share)
    # Feed the rolling utilization window (busy-ms estimator).
    from . import capacity as _capacity
    _capacity.note_busy(dur_ns, members)


def on_wait(tenant: Optional[str], qos: Optional[str],
            wait_ns: int) -> None:
    """Request-finish hook: attribute queue wait for every outcome —
    shed and errored requests attribute their wait here and nothing
    else (they never reach a dispatch span or a comm record)."""
    if not _rsettings.obs_attrib:
        return
    _attribute("wait_ns", wait_ns,
               ((tenant_label(tenant), _qos_label(qos)),))


def on_mem(name: str, delta_mb: float) -> None:
    """Watermark-exit hook: attribute positive RSS growth (KiB ints —
    counters are monotone; negative deltas are releases, not cost)."""
    if not _rsettings.obs_attrib:
        return
    kb = int(delta_mb * 1024)
    if kb > 0:
        _attribute("mem_kb", kb)


# ------------------------------------------------------------- surfaces --
def tenant_snapshot(counters_snap: Optional[dict] = None) -> dict:
    """``{tenant: {kind: value}}`` from the ``attrib.tenant.*``
    counters (a live snapshot when none is passed) — the join surface
    for the capacity report, doctor, and the ``--tenants`` table."""
    snap = (_counters.snapshot("attrib.tenant.")
            if counters_snap is None else counters_snap)
    out: dict = {}
    prefix = "attrib.tenant."
    for cname, val in snap.items():
        if not cname.startswith(prefix):
            continue
        body, _, kind = cname[len(prefix):].rpartition(".")
        if not body:
            continue
        out.setdefault(body, {})[kind] = int(val)
    return out


def reset() -> None:
    """Forget seen tenant labels (test isolation; counters are reset
    by ``counters.reset``)."""
    with _lock:
        _seen.clear()
