# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Delta layer: mutable serving views over immutable CSR matrices.

Counterpart of ``legate_sparse_tpu/delta/core.py``.  Every matrix of the
package is immutable once built; PDE remeshing and graphs that change
while they are served mutate.  :class:`DeltaCSR` serves such a matrix
without giving the immutability up:

- the **base** stays an untouched ``csr_array`` and serves through its
  own dispatch (the DIA kernel for a band);
- updates land in a **bounded COO side-buffer** of absolute entry
  updates (overwrite wins within the buffer; a 0.0 target deletes the
  entry at compaction), whose device image is padded to a power-of-two
  bucket and sorted by (row, col);
- ``dot`` serves ``base @ x + delta @ x``, the delta term through
  ``ops/spmv.py::coo_spmv_segment``; an empty buffer is the base dispatch
  alone, bit for bit (no ``+ 0``: IEEE signed zeros forbid it);
- :meth:`DeltaCSR.compact` merges the buffer into a **fresh base** and
  swaps in a new immutable :class:`DeltaView` under the lock, one
  reference store: a request that pinned a view keeps serving its
  version, later ones serve the merged base.

The additive trick: an absolute update ``A[r, c] = v`` is kept on the
device as ``v - base[r, c]`` (``v`` for an insert), so the two-term
product needs no rewrite of the base.

Off by default: with ``settings.delta`` off the constructors raise, and
no ``delta.*`` counter moves.  Counters ``delta.updates``,
``delta.applied``, ``delta.overwrites``, ``delta.served``,
``delta.compactions``, ``delta.compaction.merged``,
``delta.compaction.bytes``, ``delta.swap.versions``, ``delta.routes``,
``delta.watermark.exceeded``, ``delta.worker.errors``; events
``delta.update``, ``delta.compaction``, ``delta.watermark``,
``delta.worker.error``; histograms ``lat.delta.update`` and
``lat.delta.compaction``.  With ``settings.resil`` the merge of
``compact`` is the ``delta.compact`` fault/retry site, and an active
checkpoint scope first saves the resolved buffer to the host.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..obs import counters as _counters
from ..obs import latency as _latency
from ..obs import trace as _trace
from ..settings import settings as _settings
from ..utils import as_tensor, to_numpy

__all__ = [
    "DeltaCapacityError", "DeltaCSR", "DeltaView", "is_delta", "route",
]

_log = logging.getLogger(__name__)


class DeltaCapacityError(ValueError):
    """The bounded side-buffer is full: compact before updating."""

    def __init__(self, pending: int, capacity: int):
        self.pending = pending
        self.capacity = capacity
        super().__init__(
            f"delta buffer full: {pending} pending update slots exceed "
            f"capacity {capacity} (LEGATE_SPARSE_TPU_DELTA_CAPACITY) — "
            f"call compact() or arm the watermark worker")


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= max(n, 1): the padded device buffer's
    width."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _base_values_at(base, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """``base[r, c]`` for each update coordinate (0.0 where the slot is
    not stored: an insert), as a host array of the base's values.  A
    binary search within each row's slice of the (sorted) indices on the
    base's device, all coordinates at once: one host sync for the
    longest slice and one copy of the values back."""
    if rows.size == 0 or base.nnz == 0:
        return np.zeros(rows.shape[0])
    dev = base.device
    r = torch.from_numpy(rows).to(dev)
    c = torch.from_numpy(cols).to(dev)
    indptr, indices = base.indptr, base.indices
    lo = indptr[r].to(torch.int64)
    end = indptr[r + 1].to(torch.int64)
    hi = end.clone()
    last = base.nnz - 1
    for _ in range(int((end - lo).max()).bit_length()):
        mid = (lo + hi) // 2
        active = lo < hi
        less = indices[mid.clamp(max=last)].to(torch.int64) < c
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    j = lo.clamp(max=last)
    found = (lo < end) & (indices[j].to(torch.int64) == c)
    vals = torch.where(found, base.data[j],
                       torch.zeros((), dtype=base.dtype, device=dev))
    return to_numpy(vals)


def merged_csr(src, entries: Dict[Tuple[int, int], Tuple[float, float]]):
    """A fresh ``csr_array`` of ``src`` with buffered targets applied
    (overrides; a 0.0 target deletes), merged with tensor ops on
    ``src``'s device: keys ``row * cols + col``, a search of the buffer's
    sorted keys among the base's, and one sort of the merged keys.  It
    goes through the public COO constructor, as the JAX package's
    dict merge does (``core.py:416``), so the result is bit for bit the
    cold rebuild of the mutated matrix.  Of a non-canonical ``src``'s
    duplicates the last one stands, as in the JAX package's dict."""
    from ..csr import csr_array

    rows_b, cols_b, data_b = src._coo_parts()
    dev = data_b.device
    ncols = src.shape[1]
    bkey = rows_b.to(torch.int64) * ncols + cols_b.to(torch.int64)
    bval = data_b
    if not src.has_canonical_format:
        order = torch.argsort(bkey, stable=True)
        bkey, bval = bkey[order], bval[order]
        last = torch.ones(bkey.shape[0], dtype=torch.bool, device=dev)
        last[:-1] = bkey[:-1] != bkey[1:]
        bkey, bval = bkey[last], bval[last]
    else:
        bval = bval.clone()
    keys = sorted(entries)
    ukey = torch.tensor([r * ncols + c for r, c in keys], dtype=torch.int64,
                        device=dev)
    tgt = torch.tensor([entries[k][0] for k in keys], dtype=torch.float64,
                       device=dev)
    nb = bkey.shape[0]
    pos = torch.searchsorted(bkey, ukey)
    hit = pos < nb
    if nb:
        hit &= bkey[pos.clamp(max=nb - 1)] == ukey
    delete = tgt == 0.0
    keep = torch.ones(nb, dtype=torch.bool, device=dev)
    keep[pos[hit & delete]] = False
    over = hit & ~delete
    bval[pos[over]] = tgt[over].to(bval.dtype)
    ins = ~hit & ~delete
    allkey = torch.cat([bkey[keep], ukey[ins]])
    allval = torch.cat([bval[keep], tgt[ins].to(bval.dtype)])
    order = torch.argsort(allkey, stable=True)
    allkey, allval = allkey[order], allval[order]
    return csr_array((allval, (allkey // ncols, allkey % ncols)),
                     shape=src.shape, dtype=src.dtype)


def _nbytes(A) -> int:
    return sum(t.numel() * t.element_size()
               for t in (A.data, A.indices, A.indptr))


class DeltaView:
    """One immutable serving snapshot: (base, padded device buffer,
    version).  A request pins one and serves on it whatever swaps
    happen later; readers never lock."""

    __slots__ = ("base", "version", "pending", "_rows_dev", "_cols_dev",
                 "_dvals_dev", "_valid")

    def __init__(self, base, version: int, pending: int, rows_dev=None,
                 cols_dev=None, dvals_dev=None, valid: int = 0):
        self.base = base
        self.version = int(version)
        self.pending = int(pending)
        self._rows_dev = rows_dev
        self._cols_dev = cols_dev
        self._dvals_dev = dvals_dev
        self._valid = int(valid)

    @property
    def shape(self):
        return self.base.shape

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def dot(self, x):
        """One SpMV on the pinned version: the base's own dispatch plus
        the masked COO delta term; an empty buffer is the base dispatch
        alone."""
        xa = as_tensor(x, self.base.device)
        y = self.base.dot(xa)
        if self._valid == 0:
            return y
        from ..ops.spmv import coo_spmv_segment

        _counters.handle("delta.served").inc()
        cdt = torch.promote_types(self.base.dtype, xa.dtype)
        with _trace.span("delta.serve", version=self.version,
                         pending=self.pending, path="coo-segment"):
            yd = coo_spmv_segment(self._dvals_dev.to(cdt), self._rows_dev,
                                  self._cols_dev, self._valid, xa.to(cdt),
                                  self.base.shape[0])
        return y + yd

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"DeltaView(v{self.version}, pending={self.pending}, "
                f"base={self.base.shape})")


class _Buffer:
    """The bounded overwrite-wins update ledger of the local and the
    distributed wrappers.  Host truth is an insertion-ordered
    ``{(row, col): (target, additive)}`` dict; the device image is the
    (row, col)-sorted triple padded to the power-of-two bucket with an
    out-of-range sentinel row."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.entries: Dict[Tuple[int, int], Tuple[float, float]] = {}

    @property
    def pending(self) -> int:
        return len(self.entries)

    def ingest(self, rows, cols, vals, base_vals) -> Tuple[int, int]:
        """Apply one batch of absolute updates (the later one wins on a
        repeated coordinate).  Returns ``(new_slots, overwrites)``;
        raises :class:`DeltaCapacityError` before changing anything when
        the batch would overflow."""
        seen = set()
        new_slots = 0
        for r, c in zip(rows, cols):
            key = (int(r), int(c))
            if key not in self.entries and key not in seen:
                new_slots += 1
                seen.add(key)
        if self.pending + new_slots > self.capacity:
            raise DeltaCapacityError(self.pending + new_slots, self.capacity)
        overwrites = 0
        for r, c, v, bv in zip(rows, cols, vals, base_vals):
            key = (int(r), int(c))
            if key in self.entries:
                overwrites += 1
            self.entries[key] = (float(v), float(v) - float(bv))
        return new_slots, overwrites

    def snapshot_arrays(self):
        """Host numpy triple of the resolved buffer (rows, cols, targets
        in f64), sorted by coordinate: the checkpoint payload."""
        keys = sorted(self.entries)
        return (np.asarray([k[0] for k in keys], dtype=np.int64),
                np.asarray([k[1] for k in keys], dtype=np.int64),
                np.asarray([self.entries[k][0] for k in keys],
                           dtype=np.float64))

    def device_image(self, dtype: torch.dtype, device, sentinel_row: int,
                     start: int = 0, stop: Optional[int] = None):
        """``(row_ids, col_ids, additive_vals, valid)`` of the entries
        whose row lies in ``[start, stop)``, rows taken from ``start``,
        sorted by (row, col) and padded to the power-of-two bucket with
        ``sentinel_row``."""
        keys = sorted(k for k in self.entries
                      if k[0] >= start and (stop is None or k[0] < stop))
        n = len(keys)
        cap = _pow2_bucket(min(max(n, 1), self.capacity))
        rows = np.full(cap, sentinel_row, dtype=np.int32)
        cols = np.zeros(cap, dtype=np.int32)
        vals = np.zeros(cap, dtype=np.float64)
        if n:
            rows[:n] = [k[0] - start for k in keys]
            cols[:n] = [k[1] for k in keys]
            vals[:n] = [self.entries[k][1] for k in keys]
        # float64 -> dtype rounds once, as numpy's assignment of Python
        # floats into an array of dtype does.
        return (torch.from_numpy(rows).to(device),
                torch.from_numpy(cols).to(device),
                torch.from_numpy(vals).to(device=device, dtype=dtype), n)


def _require_enabled(what: str) -> None:
    if not _settings.delta:
        raise RuntimeError(
            f"{what} requires the delta layer (set LEGATE_SPARSE_TPU_DELTA=1 "
            f"or settings.delta = True); off by default so the immutable "
            f"serving path stays bit for bit and counter-inert")


def _check_batch(shape, rows, cols, vals):
    rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
    cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
    vals = np.atleast_1d(np.asarray(vals))
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError(
            f"delta update: rows/cols/vals shapes disagree ({rows.shape}, "
            f"{cols.shape}, {vals.shape})")
    m, n = shape
    if rows.size and (rows.min() < 0 or rows.max() >= m
                      or cols.min() < 0 or cols.max() >= n):
        raise IndexError(
            f"delta update: coordinates out of range for shape {shape}")
    return rows, cols, vals


def _watermark_slots(capacity: int) -> int:
    frac = max(float(_settings.delta_watermark), 0.0)
    return max(int(frac * capacity), 1)


def _record_update(t0: int, new_slots: int, overwrites: int, pending: int,
                   version: int, **attrs) -> None:
    _counters.inc("delta.updates")
    _counters.inc("delta.applied", new_slots)
    if overwrites:
        _counters.inc("delta.overwrites", overwrites)
    _latency.observe("lat.delta.update",
                     (time.perf_counter_ns() - t0) / 1e6)
    _trace.event("delta.update", applied=new_slots, overwrites=overwrites,
                 pending=pending, version=version, **attrs)


def _record_compaction(t0: int, merged: int, version: int, nnz: int,
                       nbytes: int, **attrs) -> None:
    _counters.inc("delta.compactions")
    _counters.inc("delta.compaction.merged", merged)
    _counters.inc("delta.compaction.bytes", nbytes)
    _counters.inc("delta.swap.versions")
    _latency.observe("lat.delta.compaction",
                     (time.perf_counter_ns() - t0) / 1e6)
    _trace.event("delta.compaction", merged=merged, version=version,
                 nnz=nnz, bytes=nbytes, **attrs)


class DeltaCSR:
    """A served matrix that mutates: an immutable base ``csr_array`` and
    a bounded COO side-buffer, with versioned compaction (module
    docstring).

    Every mutation runs under one lock and publishes a fresh immutable
    :class:`DeltaView`; ``dot`` and ``route`` read the current view with
    one reference load, so serving never waits for a compaction."""

    def __init__(self, base, capacity: Optional[int] = None):
        _require_enabled("DeltaCSR")
        from ..csr import csr_array

        if not isinstance(base, csr_array):
            base = csr_array(base)
        self._lock = threading.RLock()
        self._buffer = _Buffer(
            _settings.delta_capacity if capacity is None else capacity)
        self._view = DeltaView(base._canonicalized(), version=0, pending=0)
        self._worker: Optional[threading.Thread] = None
        self._worker_stop = threading.Event()
        self._worker_error: Optional[BaseException] = None

    # ---------------- serving surface ----------------

    @property
    def shape(self):
        return self._view.shape

    @property
    def nnz(self):
        return self._view.nnz

    @property
    def dtype(self):
        return self._view.dtype

    @property
    def device(self):
        return self._view.device

    @property
    def base(self):
        return self._view.base

    @property
    def version(self) -> int:
        return self._view.version

    @property
    def pending(self) -> int:
        return self._view.pending

    @property
    def capacity(self) -> int:
        return self._buffer.capacity

    def view(self) -> DeltaView:
        """The current immutable serving snapshot (what a request
        pins)."""
        return self._view

    def dot(self, x):
        return self._view.dot(x)

    # ---------------- mutation ----------------

    def update(self, rows, cols, vals):
        """Absolute entry updates ``A[rows[i], cols[i]] = vals[i]``
        (overwrite wins; a 0.0 target deletes the entry at compaction).
        Bounded: raises :class:`DeltaCapacityError`, changing nothing,
        when the batch would overflow the buffer."""
        t0 = time.perf_counter_ns()
        rows, cols, vals = _check_batch(self.shape, rows, cols, vals)
        with self._lock:
            self._raise_worker_error()
            view = self._view
            base_vals = _base_values_at(view.base, rows, cols)
            new_slots, overwrites = self._buffer.ingest(rows, cols, vals,
                                                        base_vals)
            self._publish(view.base, view.version)
            pending = self._buffer.pending
        _record_update(t0, new_slots, overwrites, pending, self.version)
        if pending >= _watermark_slots(self._buffer.capacity):
            _counters.inc("delta.watermark.exceeded")
            _trace.event("delta.watermark", pending=pending,
                         capacity=self._buffer.capacity)
            self._ensure_worker()

    # scipy-flavoured alias: the same absolute overwrite-wins ingestion.
    set_entries = update

    def entries(self) -> Dict[Tuple[int, int], float]:
        """Pending buffered targets ``{(row, col): value}`` (0.0 marks a
        pending delete)."""
        with self._lock:
            return {k: tv for k, (tv, _d) in self._buffer.entries.items()}

    # ---------------- compaction / versioned swap ----------------

    def compact(self) -> int:
        """Merge the buffer into a fresh base and swap versions: a view
        pinned before keeps serving, later admissions serve the merged
        base with an empty buffer.  Returns the number of entries merged
        (0: nothing pending, no swap, no counter moves)."""
        t0 = time.perf_counter_ns()
        with self._lock:
            self._raise_worker_error()
            view = self._view
            merged = self._buffer.pending
            if merged == 0:
                return 0
            if _settings.resil:
                new_base = self._resilient_merge(view)
            else:
                new_base = merged_csr(view.base, self._buffer.entries)
            self._buffer.entries.clear()
            self._publish(new_base, view.version + 1)
            version = self._view.version
        _record_compaction(t0, merged, version, new_base.nnz,
                           _nbytes(new_base))
        return merged

    def _resilient_merge(self, view):
        """The merge under the ``delta.compact`` site (JAX
        ``delta/core.py:384-397``): an active checkpoint scope first
        saves the buffer's host triple (rows, cols, targets; sorted by
        coordinate), so a loss mid-compaction re-merges from host
        truth; the merge then retries from the untouched buffer and
        base (callers hold the lock)."""
        from ..resilience import checkpoint as _ckpt
        from ..resilience import guarded_call

        ck = _ckpt.current()
        if ck is not None:
            ck.save(view.version, self._buffer.snapshot_arrays())
        return guarded_call(
            "delta.compact",
            lambda: merged_csr(view.base, self._buffer.entries))

    def _publish(self, base, version: int) -> None:
        """Swap in a fresh immutable view (callers hold the lock): one
        reference store."""
        if self._buffer.pending:
            rid, cid, dvals, valid = self._buffer.device_image(
                base.dtype, base.device, sentinel_row=base.shape[0])
            self._view = DeltaView(base, version, self._buffer.pending, rid,
                                   cid, dvals, valid)
        else:
            self._view = DeltaView(base, version, 0)

    # ---------------- watermark worker ----------------

    def maybe_compact(self) -> int:
        """Compact if the buffer is at the watermark (the worker's step;
        a serving loop may call it at its own cadence)."""
        if self._buffer.pending >= _watermark_slots(self._buffer.capacity):
            return self.compact()
        return 0

    def _raise_worker_error(self) -> None:
        """Re-raise, once, a failure of the background worker (callers
        hold the lock)."""
        err, self._worker_error = self._worker_error, None
        if err is not None:
            raise RuntimeError(
                "delta: the background compaction worker failed; the "
                "buffer is unchanged") from err

    def _ensure_worker(self) -> None:
        cadence_ms = float(_settings.delta_worker_ms)
        if cadence_ms <= 0:
            return
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker_stop.clear()
            ref = weakref.ref(self)
            stop = self._worker_stop
            dev = self.base.device

            def loop():
                # A new thread starts on the current device 0: enter the
                # base's before touching the card.
                ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                       else contextlib.nullcontext())
                with ctx:
                    while not stop.wait(cadence_ms / 1e3):
                        owner = ref()
                        if owner is None:
                            return
                        try:
                            owner.maybe_compact()
                        except Exception as exc:
                            # Kept for the next update()/compact() to
                            # raise; the worker stops.
                            _log.exception("delta compaction worker failed")
                            _counters.inc("delta.worker.errors")
                            _trace.event("delta.worker.error",
                                         error=repr(exc))
                            with owner._lock:
                                owner._worker_error = exc
                            return
                        if owner._buffer.pending == 0:
                            return
                        del owner

            t = threading.Thread(target=loop, daemon=True,
                                 name="delta-compaction-worker")
            self._worker = t
            t.start()

    def stop_worker(self) -> None:
        """Stop a running background compaction worker."""
        self._worker_stop.set()
        t = self._worker
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"DeltaCSR(v{self.version}, "
                f"pending={self.pending}/{self.capacity}, "
                f"base={self.base.shape})")


def is_delta(A) -> bool:
    return isinstance(A, DeltaCSR)


def route(A):
    """Admission-time routing: a :class:`DeltaCSR` is swapped for its
    current immutable :class:`DeltaView` (the version pinned now);
    anything else passes through."""
    if not isinstance(A, DeltaCSR):
        return A
    _counters.inc("delta.routes")
    return A.view()
