# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Streaming latency histograms: mergeable fixed-log2-bucket
distributions with bounded relative quantile error.

The port's copy of ``legate_sparse_tpu/obs/latency.py``: the same
bucket grid, names and error bound, so a histogram of one package reads
like the other's.  Every observation lands in one of ~500 logarithmic
buckets, so a histogram is a few KB no matter how many calls it
absorbs, two histograms merge by adding bucket counts, and any quantile
is reconstructible to a *documented* relative error.

Bucket layout
-------------
``SUB`` sub-buckets per power of two: a positive value ``v`` lands in
bucket ``floor(log2(v) * SUB)`` (clamped to the supported range;
values <= 0 land in a dedicated zero bucket that reports 0.0).
Quantiles report the geometric midpoint of their bucket, so the
relative error of any quantile estimate is bounded by

    REL_ERR = 2 ** (1 / (2 * SUB)) - 1        (~4.4% at SUB = 8)

The clamp range covers ~7.5e-9 .. 1.4e11 — nanoseconds to days in ms
units — clamped extremes saturate into the edge buckets (count
preserved, error bound void there by design).

Hot-path contract
-----------------
Histograms are ALWAYS on, and the write path is the per-thread
buffered ``HistHandle``: ``observe`` is one ``log2``, one list-element
add and one float add on objects owned by the calling thread.  No lock,
no allocation, no device sync: a ``timer`` measures the host's
dispatch wall time, as the JAX package's does, never the card's (that
is what CUDA events are for).  Snapshots merge every live handle under
the module lock with the same monotone-total / rebased-base scheme as
``counters.Handle``.

Naming convention::

    lat.<op>.<shape-bucket>      per-op dispatch latency in ms, keyed
                                 by the pow2 shape bucket ("n4096"):
                                 spmv, spmm, spgemm, cg.solve,
                                 gmres.cycle, bicgstab.solve
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

# Sub-buckets per power of two.  8 => quantile relative error <= 4.4%.
SUB = 8
# Documented quantile error bound: estimates report the geometric
# midpoint of a bucket whose bounds are a factor 2**(1/SUB) apart.
REL_ERR = 2 ** (1.0 / (2 * SUB)) - 1

# Supported exponent range (powers of two).  Values in ms: 2**-27 ms
# (~7.5e-9) up to 2**37 ms (~4.3 years).  Slot 0 is the zero bucket.
_MIN_EXP = -27
_MAX_EXP = 37
_LO = _MIN_EXP * SUB
_NSLOTS = (_MAX_EXP - _MIN_EXP) * SUB + 1   # +1 for the zero bucket


def _slot(value: float) -> int:
    """Bucket slot for ``value`` (slot 0 = zero bucket)."""
    if value <= 0.0 or value != value:      # <= 0 and NaN: zero bucket
        return 0
    idx = math.floor(math.log2(value) * SUB) - _LO
    if idx < 0:
        idx = 0
    elif idx >= _NSLOTS - 1:
        idx = _NSLOTS - 2
    return idx + 1


def slot_upper(slot: int) -> float:
    """Upper bound of ``slot`` (0.0 for the zero bucket) — the
    OpenMetrics ``le`` boundary."""
    if slot <= 0:
        return 0.0
    return 2.0 ** ((slot + _LO) / SUB)


def _slot_mid(slot: int) -> float:
    """Representative value of ``slot``: geometric midpoint (the
    REL_ERR-bounded quantile estimate)."""
    if slot <= 0:
        return 0.0
    return 2.0 ** ((slot - 0.5 + _LO) / SUB)


def shape_bucket(n: int) -> str:
    """Stable pow2 shape-bucket label ("n4096") for histogram names.

    Deliberately independent of any tunable bucket ladder: histogram
    names must stay comparable across runs and across the two
    packages."""
    return f"n{1 << max(int(n) - 1, 0).bit_length()}"


class Histogram:
    """A merged, immutable-by-convention histogram snapshot."""

    __slots__ = ("name", "counts", "sum")

    def __init__(self, name: str, counts: List[int], total: float):
        self.name = name
        self.counts = counts
        self.sum = total

    @property
    def count(self) -> int:
        return sum(self.counts)

    @property
    def mean(self) -> Optional[float]:
        n = self.count
        return (self.sum / n) if n else None

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile estimate, within REL_ERR of the exact
        sorted value (None on an empty histogram)."""
        n = self.count
        if n == 0:
            return None
        rank = max(1, min(n, math.ceil(float(q) * n)))
        acc = 0
        for slot, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return _slot_mid(slot)
        return _slot_mid(_NSLOTS - 1)   # pragma: no cover - unreachable

    def max(self) -> Optional[float]:
        """Upper bound of the highest occupied bucket (within one
        bucket width of the true max)."""
        for slot in range(_NSLOTS - 1, -1, -1):
            if self.counts[slot]:
                return slot_upper(slot)
        return None

    def merge(self, other: "Histogram") -> "Histogram":
        """Cross-thread / cross-process combination: bucket counts and
        sums add (the whole point of fixed buckets)."""
        counts = [a + b for a, b in zip(self.counts, other.counts)]
        return Histogram(self.name, counts, self.sum + other.sum)

    def nonzero_buckets(self) -> List[tuple]:
        """[(slot, count), ...] for occupied slots — the sparse
        serialized form."""
        return [(s, c) for s, c in enumerate(self.counts) if c]

    def to_dict(self) -> Dict:
        """Sparse serializable form (trace artifacts, persisted
        ledgers); ``from_dict`` round-trips it."""
        return {
            "sub": SUB,
            "count": self.count,
            "sum": self.sum,
            "buckets": [[s, c] for s, c in self.nonzero_buckets()],
        }

    @classmethod
    def from_dict(cls, name: str, d: Dict) -> "Histogram":
        sub = int(d.get("sub", SUB))
        if sub != SUB:
            # Slot indices are meaningless on a different grid:
            # reinterpreting them would silently skew every quantile
            # by up to 2**(k/sub - k/SUB).
            raise ValueError(
                f"histogram {name!r} was recorded with SUB={sub}, "
                f"this build uses SUB={SUB}; incompatible bucket grid")
        counts = [0] * _NSLOTS
        for s, c in d.get("buckets", []):
            if 0 <= int(s) < _NSLOTS:
                counts[int(s)] += int(c)
        return cls(name, counts, float(d.get("sum", 0.0)))


class HistHandle:
    """Per-thread buffered histogram: the lock-free write path.

    Mirrors ``counters.Handle``: per-slot counts and the running sum
    grow monotonically and ONLY the owning thread writes them;
    ``reset`` (under the module lock) advances the ``_base`` copies
    instead of mutating, so reads are tear-free and a concurrent
    ``observe`` can never be lost or double-counted."""

    __slots__ = ("name", "_counts", "_base", "_sum", "_sum_base",
                 "_thread")

    def __init__(self, name: str):
        self.name = name
        self._counts = [0] * _NSLOTS
        self._base = [0] * _NSLOTS
        self._sum = 0.0
        self._sum_base = 0.0
        self._thread = threading.current_thread()

    def observe(self, value: float) -> None:
        """Owner-thread-only record: no lock taken.  Negative / NaN
        values land in the zero bucket and contribute 0 to the sum
        (the sum must stay monotone for the rebase contract)."""
        v = float(value)
        self._counts[_slot(v)] += 1
        if v > 0.0:
            self._sum += v

    def _pending(self) -> tuple:
        """(counts-delta list, sum-delta) not yet consumed by reset."""
        counts = [t - b for t, b in zip(self._counts, self._base)]
        return counts, self._sum - self._sum_base


_lock = threading.Lock()
_tls = threading.local()
_handles: List[HistHandle] = []          # registry, appended under _lock
# Dead-thread fold target: {name: (counts, sum)} merged under _lock.
_folded: Dict[str, tuple] = {}

_COMPACT_THRESHOLD = 512


def _compact_locked() -> None:
    """Fold handles owned by dead threads into ``_folded`` and drop
    them (call under _lock) — same bound as ``counters``: a
    thread-pool-per-request service must not leak one handle per
    (thread, name) forever."""
    global _handles
    live: List[HistHandle] = []
    for h in _handles:
        if h._thread.is_alive():
            live.append(h)
            continue
        counts, total = h._pending()
        if any(counts) or total:
            base_c, base_s = _folded.get(h.name,
                                         ([0] * _NSLOTS, 0.0))
            _folded[h.name] = (
                [a + b for a, b in zip(base_c, counts)],
                base_s + total)
    _handles = live


def handle(name: str) -> HistHandle:
    """The calling thread's buffered handle for histogram ``name``
    (created and registered on first use).  Keep the returned object
    and call ``h.observe(ms)`` in hot loops."""
    reg = getattr(_tls, "handles", None)
    if reg is None:
        reg = _tls.handles = {}
    h = reg.get(name)
    if h is None:
        h = HistHandle(name)
        reg[name] = h
        with _lock:
            if len(_handles) >= _COMPACT_THRESHOLD:
                _compact_locked()
            _handles.append(h)
    return h


def observe(name: str, value: float) -> None:
    """Record one observation into histogram ``name`` (convenience
    over ``handle(name).observe(value)``)."""
    handle(name).observe(value)


class timer:
    """Context manager recording the wall time of its body (in ms)
    into histogram ``name`` — the dispatch-site instrumentation
    (``with _lat.timer("lat.spmv." + _lat.shape_bucket(n)): ...``).
    Always on, like the histograms themselves: one clock pair + one
    buffered observe, no lock, no device sync."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "timer":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        observe(self.name,
                (time.perf_counter_ns() - self._t0) / 1e6)


def _merged_locked(name: str) -> Optional[Histogram]:
    counts = [0] * _NSLOTS
    total = 0.0
    seen = False
    folded = _folded.get(name)
    if folded is not None:
        counts = list(folded[0])
        total = folded[1]
        seen = True
    for h in _handles:
        if h.name != name:
            continue
        c, s = h._pending()
        if any(c) or s:
            counts = [a + b for a, b in zip(counts, c)]
            total += s
        seen = True
    if not seen:
        return None
    return Histogram(name, counts, total)


def get(name: str) -> Optional[Histogram]:
    """Merged snapshot of one histogram (None if never observed)."""
    with _lock:
        return _merged_locked(name)


def snapshot(prefix: Optional[str] = None) -> Dict[str, Histogram]:
    """Merged snapshot of all histograms, optionally filtered by name
    prefix.  Tear-free per histogram (each merge reads monotone
    per-thread totals under the module lock).  One O(handles) pass —
    NOT one registry scan per name: this runs on every OpenMetrics
    scrape and trace export, possibly against a near-compaction-bound
    registry, while holding the lock new registrations need."""
    with _lock:
        out: Dict[str, Histogram] = {}
        for name, (counts, total) in _folded.items():
            if prefix is not None and not name.startswith(prefix):
                continue
            out[name] = Histogram(name, list(counts), total)
        for h in _handles:
            name = h.name
            if prefix is not None and not name.startswith(prefix):
                continue
            c, s = h._pending()
            hist = out.get(name)
            if hist is None:
                out[name] = Histogram(name, c, s)
            else:
                hist.counts = [a + b for a, b in zip(hist.counts, c)]
                hist.sum += s
        return dict(sorted(out.items()))


def reset(prefix: Optional[str] = None) -> None:
    """Zero all histograms (or those under ``prefix``): live handles
    are re-based, not mutated; folded dead-thread state is dropped."""
    with _lock:
        for name in [n for n in _folded
                     if prefix is None or n.startswith(prefix)]:
            del _folded[name]
        for h in _handles:
            if prefix is None or h.name.startswith(prefix):
                h._base[:] = h._counts
                h._sum_base = h._sum
