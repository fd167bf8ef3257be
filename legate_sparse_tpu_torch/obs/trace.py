# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Op-level tracing: near-zero-overhead spans and structured events.

The port's copy of ``legate_sparse_tpu/obs/trace.py``.  Every hot path
wraps its Python-level dispatch in

    with obs.span("spmv", nnz=nnz) as sp:
        y = kernel(...)
        if sp is not None:
            sp.set(path="ell")     # attrs discovered during the op

and the recorded spans export as newline-JSON or Chrome-trace/Perfetto
format.

Overhead contract
-----------------
Disabled (the default), ``span()`` touches one module global and
returns a shared no-op context manager — no allocation, no clock read.
Tracing activates only through ``LEGATE_SPARSE_TPU_OBS=1`` (read at
import, the JAX package's switch), ``settings.obs = True`` or
``enable()``.  A span times the host's dispatch of its body and never
synchronises with the card: a kernel launched inside it may still be
running when it closes.  Device time is measured with CUDA events, or
by joining the spans to a ``torch.profiler`` trace (``obs.timeline``).

Clock
-----
Every time stamp here (``Span``, ``event``) comes from ``clock_ns``,
and callers of ``complete_span`` take theirs from it too, so all
records share one time axis.  ``obs.timeline`` maps that axis onto the
profiler's with an offset read from an anchor both sides record.

First call vs steady state
--------------------------
Spans carry a per-name sequence number: occurrence 0 of a name is the
first call (it builds structure caches, and a kernel's first launch
builds it with nvcc), later occurrences are steady state.

Spans and events closed while a request's trace context is active
(``obs.context``) carry its ``trace_id``; the Chrome trace binds the
tagged slices of one request into a flow arc.  A closing span also
calls ``attrib.on_span_close`` (one flag read while
``settings.obs_attrib`` is off): the dispatch spans charge their wall
time to the active tenant members, on the host, with no device read.
"""

from __future__ import annotations

import functools
import io
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import attrib as _attrib
from . import context as _context
from . import counters as _counters

# Span attribute keys that auto-accumulate into the process-wide
# counters when a span closes (tentpole contract: nnz processed and
# bytes moved are counters, not just per-span attrs).
_ACCUMULATED_ATTRS = {"nnz": "obs.nnz_processed", "bytes": "obs.bytes_moved",
                      "flops": "obs.flops"}

_lock = threading.Lock()
_records: List[Dict[str, Any]] = []
_seq_by_name: Dict[str, int] = {}
_tls = threading.local()

# Hard cap on buffered records: an unbounded-session safety valve (a
# long-lived service with tracing left on must not leak memory without
# bound).  Overflow drops new spans and counts them.
MAX_RECORDS = int(os.environ.get("LEGATE_SPARSE_TPU_OBS_MAX_RECORDS",
                                 1_000_000))


def _env_enabled() -> bool:
    val = os.environ.get("LEGATE_SPARSE_TPU_OBS")
    if val is None:
        return False
    return val.lower() not in ("0", "false", "no", "off", "")


_enabled: bool = _env_enabled()


def enabled() -> bool:
    """Fast hot-path check: is tracing on?"""
    return _enabled


def enable() -> None:
    """Turn span/event recording on for this process."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn span/event recording off (buffered records are kept)."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all buffered records and per-name sequence state."""
    with _lock:
        _records.clear()
        _seq_by_name.clear()


def clock_ns() -> int:
    """The clock of every record: ``time.perf_counter_ns``."""
    return time.perf_counter_ns()


def _depth_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """One recorded operation.  Use via ``span()``; ``set()`` attaches
    attributes discovered while the op runs (kernel choice, output
    nnz)."""

    __slots__ = ("name", "attrs", "_t0", "_t1", "_depth")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._t0 = 0
        self._t1 = 0
        self._depth = 0

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def stop(self) -> "Span":
        """End the span's interval here: the rest of the body (pricing
        the span's own attributes) runs outside it."""
        self._t1 = clock_ns()
        return self

    def __enter__(self) -> "Span":
        st = _depth_stack()
        self._depth = len(st)
        st.append(self.name)
        self._t0 = clock_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = (self._t1 or clock_ns()) - self._t0
        st = _depth_stack()
        if st and st[-1] == self.name:
            st.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        # A span closed under a request's trace context belongs to its
        # flow arc; explicit ids (a batch naming its members) win.
        if "trace_id" not in self.attrs and "trace_ids" not in self.attrs:
            tid_ctx = _context.current_trace_id()
            if tid_ctx is not None:
                self.attrs["trace_id"] = tid_ctx
        with _lock:
            seq = _seq_by_name.get(self.name, 0)
            _seq_by_name[self.name] = seq + 1
            if len(_records) >= MAX_RECORDS:
                _counters.inc("obs.dropped_records")
            else:
                rec = {
                    "type": "span",
                    "name": self.name,
                    "ts_ns": self._t0,
                    "dur_ns": dur,
                    "depth": self._depth,
                    "seq": seq,
                    "first": seq == 0,
                    "tid": threading.get_ident(),
                }
                if self.attrs:
                    rec["attrs"] = self.attrs
                _records.append(rec)
        # Counter accumulation is independent of the span buffer: it
        # must keep counting even when overflow drops the records
        # (counters advertise process-lifetime totals).
        for key, counter in _ACCUMULATED_ATTRS.items():
            val = self.attrs.get(key)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                _counters.inc(counter, val)
        # Per-tenant attribution: dispatch busy spans charge their wall
        # time to the active tenant members.
        _attrib.on_span_close(self.name, dur, seq == 0)


class _NullSpan:
    """Shared disabled-mode context manager: no allocation per call."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None

    def set(self, **attrs: Any) -> "_NullSpan":  # tolerate stray .set()
        return self


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs: Any):
    """Context manager recording one operation.

    Yields the live ``Span`` when tracing is enabled (so the body can
    ``sp.set(...)`` late attributes) and ``None`` when disabled —
    guard late-attribute work with ``if sp is not None``.
    """
    if not _enabled:
        return _NULL_SPAN
    return Span(name, attrs)


def traced(name: str):
    """Decorator: every call of the function inside ``span(name)``
    (the kernel wrappers' ``kernel.*`` spans).  Disabled, it costs one
    call and one flag read."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def complete_span(name: str, start_ns: int, dur_ns: int,
                  **attrs: Any) -> None:
    """Record an externally-timed span — a lifecycle that starts in
    one thread and ends in another, where a context manager can't
    bracket it, or laps a caller already takes.  ``start_ns`` is a
    ``clock_ns`` reading.  Takes the same per-name sequence slot and
    buffer-cap treatment as ``Span``; ``depth`` is 0 (cross-thread
    lifecycles have no nesting stack)."""
    if not _enabled:
        return
    if "trace_id" not in attrs and "trace_ids" not in attrs:
        tid_ctx = _context.current_trace_id()
        if tid_ctx is not None:
            attrs["trace_id"] = tid_ctx
    with _lock:
        seq = _seq_by_name.get(name, 0)
        _seq_by_name[name] = seq + 1
        if len(_records) >= MAX_RECORDS:
            _counters.inc("obs.dropped_records")
            return
        rec: Dict[str, Any] = {
            "type": "span",
            "name": name,
            "ts_ns": int(start_ns),
            "dur_ns": int(dur_ns),
            "depth": 0,
            "seq": seq,
            "first": seq == 0,
            "tid": threading.get_ident(),
        }
        if attrs:
            rec["attrs"] = attrs
        _records.append(rec)


def event(name: str, **attrs: Any) -> None:
    """Record an instant (zero-duration) structured event — e.g. an
    accelerator-probe failure, a collective-realization decline."""
    if not _enabled:
        return
    if "trace_id" not in attrs:
        tid_ctx = _context.current_trace_id()
        if tid_ctx is not None:
            attrs = dict(attrs, trace_id=tid_ctx)
    with _lock:
        if len(_records) >= MAX_RECORDS:
            _counters.inc("obs.dropped_records")
            return
        rec: Dict[str, Any] = {
            "type": "event",
            "name": name,
            "ts_ns": clock_ns(),
            "tid": threading.get_ident(),
        }
        if attrs:
            rec["attrs"] = rec_attrs = {}
            for k, v in attrs.items():
                rec_attrs[k] = v
        _records.append(rec)


def mark() -> int:
    """Where the buffer ends now: ``records(mark())`` later holds the
    records made since."""
    with _lock:
        return len(_records)


def records(since: int = 0) -> List[Dict[str, Any]]:
    """Snapshot of the buffered records from position ``since`` on
    (copy; safe to mutate)."""
    with _lock:
        return [dict(r) for r in _records[since:]]


def _json_default(obj: Any) -> Any:
    # Span attrs may carry numpy scalars / dtypes; stringify anything
    # the stdlib encoder rejects rather than losing the whole trace.
    try:
        import numpy as np

        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
    except Exception:
        pass
    return str(obj)


def write_jsonl(path: str) -> int:
    """Export the buffer as newline-JSON (one record per line).
    Returns the number of records written."""
    recs = records()
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r, default=_json_default) + "\n")
    return len(recs)


def to_chrome_trace(extra_metadata: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Render the buffer in Chrome-trace ("Trace Event") format — loads
    directly in Perfetto / chrome://tracing.  Spans become complete
    ("X") events, events become instants ("i"); counters ride along as
    process metadata."""
    pid = os.getpid()
    trace_events: List[Dict[str, Any]] = []
    # Flow anchors: spans tagged with a trace id, singly (``trace_id``)
    # or as a batch's member list (``trace_ids``).
    flow_anchors: Dict[str, List[Dict[str, Any]]] = {}
    for r in records():
        ev: Dict[str, Any] = {
            "name": r["name"],
            "pid": pid,
            "tid": r.get("tid", 0),
            "ts": r["ts_ns"] / 1e3,       # Chrome trace wants us
        }
        args = dict(r.get("attrs") or {})
        if r["type"] == "span":
            ev["ph"] = "X"
            ev["dur"] = r["dur_ns"] / 1e3
            args["seq"] = r["seq"]
            args["first_call"] = r["first"]
            ids = [args["trace_id"]] if isinstance(
                args.get("trace_id"), str) else []
            ids += [t for t in (args.get("trace_ids") or ())
                    if isinstance(t, str)]
            for t in ids:
                flow_anchors.setdefault(t, []).append(ev)
        else:
            ev["ph"] = "i"
            ev["s"] = "p"
        if args:
            ev["args"] = args
        trace_events.append(ev)
    # One flow arc per trace id ("s" start, "t" step, "f" finish), each
    # record on its anchor slice's coordinates: Perfetto draws the
    # request as one connected arc (gateway.admit -> the batch -> the
    # dispatch).
    for trace_id, anchors in sorted(flow_anchors.items()):
        if len(anchors) < 2:
            continue
        anchors.sort(key=lambda ev: ev["ts"])
        last = len(anchors) - 1
        for i, anchor in enumerate(anchors):
            flow: Dict[str, Any] = {
                "name": "request", "cat": "flow",
                "ph": "s" if i == 0 else ("f" if i == last else "t"),
                "id": trace_id, "pid": pid, "tid": anchor["tid"],
                "ts": anchor["ts"],
            }
            if i == last:
                flow["bp"] = "e"
            trace_events.append(flow)
    from . import latency as _latency

    meta: Dict[str, Any] = {
        "counters": _counters.snapshot(),
        # Sparse serialized histograms (latency.py): the artifact
        # carries the full distributions.
        "histograms": {name: h.to_dict()
                       for name, h in _latency.snapshot().items()},
        "format": "legate_sparse_tpu.obs/1",
    }
    if extra_metadata:
        meta.update(extra_metadata)
    return {"traceEvents": trace_events, "otherData": meta}


def write_chrome_trace(path: str,
                       extra_metadata: Optional[Dict[str, Any]] = None
                       ) -> int:
    """Export the buffer as a Chrome-trace JSON file.  Returns the
    number of trace events written."""
    doc = to_chrome_trace(extra_metadata)
    buf = io.StringIO()
    json.dump(doc, buf, default=_json_default)
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return len(doc["traceEvents"])
