# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Process-wide counters: op invocations, host<->device transfers,
scipy-fallback hits, structure builds.

The port's copy of ``legate_sparse_tpu/obs/counters.py``, under the
same names and semantics.  Counters are ALWAYS on (unlike spans): one
dict increment costs tens of nanoseconds, and the point is that a later
diagnosis can ask "how many times did the scipy fallback fire in this
run?" without having had tracing enabled in advance.  Naming
convention, as in the JAX package::

    op.<name>            python-level op dispatches (spmv, spmm,
                         spgemm, cg, gmres, bicgstab)
    transfer.<name>      host<->device movements (``host_sync.*``:
                         fetches that wait for the device)
    build.<name>         structure builds (``build.csr.coo.<r>x<c>``)
    scipy_fallback.<name>  host-scipy escape-hatch hits
    comm.<name>          the communication ledger (``comm.py``)
    obs.nnz_processed / obs.bytes_moved / obs.flops
                         accumulated from span attributes (only while
                         tracing is enabled)

The JAX package's ``trace.<name>`` counters count jit retraces; eager
PyTorch has none, so the port does not emit them.

``inc`` is intentionally tolerant of float increments (bytes/flops
totals).  Thread safety: increments take the module lock; reads
snapshot under it.

Hot-loop sites (per-call dispatch counters, the per-call comm ledger)
skip the lock with a **per-thread buffered handle** (``handle(name)``):
``Handle.inc`` is one attribute add on an object owned by the calling
thread — no lock, no dict.  Buffered values are merged into every
``get``/``snapshot`` (the flush-on-read contract).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Union

Number = Union[int, float]

_lock = threading.Lock()
_counters: Dict[str, Number] = {}


class Handle:
    """Per-thread buffered counter: the lock-free hot-loop fast path.

    ``inc`` adds to a plain attribute that ONLY the owning thread
    writes (CPython attribute reads are GIL-atomic, so readers in
    other threads see a consistent — at worst slightly stale — value).
    Nothing is ever popped from the handle: ``_total`` grows
    monotonically and readers report ``_total - _base``, where
    ``_base`` is advanced (under the module lock) by ``reset()``.
    That makes reads tear-free and reset race-safe: an increment that
    lands concurrently with a reset simply survives as post-reset
    count — no increment can be lost or double-counted.
    """

    __slots__ = ("name", "_total", "_base", "_thread")

    def __init__(self, name: str):
        self.name = name
        self._total: Number = 0
        self._base: Number = 0
        self._thread = threading.current_thread()

    def inc(self, value: Number = 1) -> None:
        """Owner-thread-only add: no lock taken."""
        self._total += value

    def pending(self) -> Number:
        """Buffered amount not yet consumed by a ``reset()``."""
        return self._total - self._base


_tls = threading.local()
_handles: List[Handle] = []      # registry, appended under _lock

# Registry size that triggers a dead-thread sweep on the next handle
# registration — bounds a thread-pool-per-request service that touches
# fresh threads forever (each dead thread's handles fold their pending
# amounts into the base counters and drop out of the scan path).
_COMPACT_THRESHOLD = 512


def _compact_locked() -> None:
    """Fold handles owned by dead threads into ``_counters`` and drop
    them (call under _lock).  Safe: a dead thread can no longer
    increment, so its pending amount is final."""
    global _handles
    live: List[Handle] = []
    for h in _handles:
        if h._thread.is_alive():
            live.append(h)
            continue
        d = h._total - h._base
        if d:
            _counters[h.name] = _counters.get(h.name, 0) + d
    _handles = live


def handle(name: str) -> Handle:
    """The calling thread's buffered handle for counter ``name``
    (created and registered on first use).  Keep the returned object
    and call ``h.inc()`` in hot loops; ``snapshot()``/``get()`` fold
    the buffered values in automatically."""
    reg = getattr(_tls, "handles", None)
    if reg is None:
        reg = _tls.handles = {}
    h = reg.get(name)
    if h is None:
        h = Handle(name)
        reg[name] = h
        with _lock:
            if len(_handles) >= _COMPACT_THRESHOLD:
                _compact_locked()
            _handles.append(h)
    return h


def _pending_locked() -> Dict[str, Number]:
    """Sum of every live handle's un-reset buffer (call under _lock)."""
    out: Dict[str, Number] = {}
    for h in _handles:
        d = h._total - h._base
        if d:
            out[h.name] = out.get(h.name, 0) + d
    return out


def inc(name: str, value: Number = 1) -> None:
    """Add ``value`` to counter ``name`` (creating it at 0)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def get(name: str, default: Number = 0) -> Number:
    """Current value of one counter (buffered handles included)."""
    with _lock:
        base = _counters.get(name)
        buf = 0
        for h in _handles:
            if h.name == name:
                buf += h._total - h._base
        if base is None and not buf:
            return default
        return (base or 0) + buf


def snapshot(prefix: Optional[str] = None) -> Dict[str, Number]:
    """Copy of all counters (buffered handles folded in), optionally
    filtered by name prefix."""
    with _lock:
        out = dict(_counters)
        for name, d in _pending_locked().items():
            out[name] = out.get(name, 0) + d
        if prefix is None:
            return out
        return {k: v for k, v in out.items() if k.startswith(prefix)}


def reset(prefix: Optional[str] = None) -> None:
    """Zero all counters, or only those under ``prefix`` (buffered
    handles are re-based, not mutated — see ``Handle``)."""
    with _lock:
        if prefix is None:
            _counters.clear()
        else:
            for k in [k for k in _counters if k.startswith(prefix)]:
                del _counters[k]
        for h in _handles:
            if prefix is None or h.name.startswith(prefix):
                h._base = h._total
