# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Verdict store: measured kernel choices, LRU + optional on-disk JSON
(the port of ``legate_sparse_tpu/autotune/store.py``, same file format).

A *verdict* is the harness's measured answer ("for matrices of this
fingerprint class / op / dtype / shape bucket on this platform, kernel
X wins") and the store is its home — the autotune analog of the
engine's plan cache, with the same thread-safe move-to-end LRU shape
(``engine/plan_cache.py``).

Key and invalidation contract
-----------------------------
:class:`VerdictKey` carries ``(op, dtype, fingerprint class, rows
bucket, nnz bucket, k bucket, platform fingerprint, settings.epoch,
storage)``.  Shape terms reuse the engine's bucket policy, so one
verdict covers a bucket, not an exact shape.  The ``dtype`` term is
the *storage* value dtype (``csr_array.compress`` keeps ``.dtype``
honest), and ``storage`` tags the index representation — so a verdict
measured over bf16 values or int16 indices can never replay against
f32/int32 storage of the same logical matrix.  Two terms invalidate
without eviction:

- ``epoch`` — any post-import mutation of a lowering-relevant setting
  bumps ``settings.epoch`` (settings.py contract), so stale verdicts
  simply stop matching;
- ``platform`` — ``"<device type>:<device name>:<device count>"`` of
  the default device (``"cuda:NVIDIA H100 80GB HBM3:1"``,
  ``"cpu:cpu:1"``; the JAX package reads ``jax.devices()``); a verdict
  measured on one machine class never routes on another.

Persistence: when ``LEGATE_SPARSE_TPU_AUTOTUNE_STORE`` names a file,
every record atomically rewrites it (temp + rename) and construction
loads it back, dropping entries whose platform fingerprint or epoch
does not match the current process — the on-disk file is a warm-start
cache, never an authority.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

import torch

from .. import obs as _obs
from ..engine import buckets as _buckets
from ..settings import settings as _settings

def platform_fingerprint() -> str:
    """``"<type>:<name>:<count>"`` of the default device: its CUDA
    name and the visible card count, or ``"cpu:cpu:1"``."""
    from ..runtime import default_device

    dev = default_device()
    if dev.type == "cuda":
        return (f"cuda:{torch.cuda.get_device_name(dev)}:"
                f"{torch.cuda.device_count()}")
    return f"{dev.type}:{dev.type}:1"


@dataclass(frozen=True)
class VerdictKey:
    op: str
    dtype: str
    fp_class: str
    rows_b: int
    nnz_b: int
    k_b: int
    platform: str
    epoch: int
    # Storage-representation tag beyond the value dtype (which the
    # ``dtype`` term already keys): "" for canonical int32 column
    # indices, "i16" for compressed indices.  A verdict measured over
    # one byte layout never replays against another — the index width
    # changes the gather traffic the race actually measured.
    storage: str = ""

    @property
    def key_id(self) -> str:
        """Compact display id (obs events)."""
        storage = f"/s{self.storage}" if self.storage else ""
        return (f"{self.op}/{self.dtype}/{self.fp_class}"
                f"/r{self.rows_b}/z{self.nnz_b}/k{self.k_b}{storage}"
                f"@{self.platform}/e{self.epoch}")


@dataclass
class Verdict:
    """One measured choice: the winning label plus the full timing
    table it was drawn from (kept as evidence)."""

    label: str
    timings_ms: Dict[str, float] = field(default_factory=dict)
    trials: int = 0


def key_for(A, op: str = "spmv", k: int = 1) -> Optional[VerdictKey]:
    """Verdict key of a ``csr_array`` for ``op``."""
    fp = A._get_fingerprint()
    storage = ""
    if A.indices.element_size() < 4:
        storage = f"i{A.indices.element_size() * 8}"
    return VerdictKey(
        op=op,
        dtype=str(A.dtype).replace("torch.", ""),
        fp_class=fp.klass,
        rows_b=_buckets.bucket(A.shape[0]),
        nnz_b=_buckets.bucket(A.nnz),
        k_b=_buckets.k_bucket(k),
        platform=platform_fingerprint(),
        epoch=_settings.epoch,
        storage=storage,
    )


class VerdictStore:
    """Thread-safe LRU of verdicts with optional JSON persistence."""

    def __init__(self, capacity: Optional[int] = None,
                 path: Optional[str] = None):
        self._capacity = (capacity if capacity is not None
                          else _settings.autotune_store_size)
        self._path = (path if path is not None
                      else (_settings.autotune_store_path or None))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[VerdictKey, Verdict]" = OrderedDict()
        if self._path:
            self._load()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, key: Optional[VerdictKey]) -> Optional[Verdict]:
        if key is None:
            return None
        with self._lock:
            verdict = self._entries.get(key)
            if verdict is not None:
                self._entries.move_to_end(key)
        if verdict is None:
            _obs.inc("autotune.verdict.misses")
            return None
        _obs.inc("autotune.verdict.hits")
        return verdict

    def record(self, key: VerdictKey, label: str,
               timings_ms: Optional[Dict[str, float]] = None,
               trials: int = 0) -> Verdict:
        verdict = Verdict(label=label,
                          timings_ms=dict(timings_ms or {}),
                          trials=int(trials))
        with self._lock:
            self._entries[key] = verdict
            self._entries.move_to_end(key)
            while len(self._entries) > max(self._capacity, 1):
                self._entries.popitem(last=False)
                _obs.inc("autotune.verdict.evictions")
        _obs.inc("autotune.verdict.records")
        _obs.event("autotune.verdict", key=key.key_id, label=label)
        if self._path:
            self._save()
        return verdict

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> Dict[str, int]:
        snap = _obs.counters.snapshot("autotune.verdict.")
        return {
            "size": len(self),
            "hits": int(snap.get("autotune.verdict.hits", 0)),
            "misses": int(snap.get("autotune.verdict.misses", 0)),
            "records": int(snap.get("autotune.verdict.records", 0)),
            "evictions": int(snap.get("autotune.verdict.evictions", 0)),
        }

    # ---------------- persistence ----------------

    def _save(self) -> None:
        with self._lock:
            entries = [dict(asdict(key), label=v.label,
                            timings_ms=v.timings_ms, trials=v.trials)
                       for key, v in self._entries.items()]
        doc = {"platform": platform_fingerprint(),
               "epoch": _settings.epoch, "verdicts": entries}
        tmp = f"{self._path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, self._path)
        except OSError as e:
            _obs.event("autotune.store.error", error=repr(e)[:200])
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        _obs.inc("autotune.store.save")

    def _load(self) -> None:
        try:
            with open(self._path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return  # absent/corrupt warm-start file: start empty
        dropped = 0
        for entry in doc.get("verdicts", []):
            try:
                key = VerdictKey(
                    op=entry["op"], dtype=entry["dtype"],
                    fp_class=entry["fp_class"],
                    rows_b=int(entry["rows_b"]),
                    nnz_b=int(entry["nnz_b"]),
                    k_b=int(entry["k_b"]),
                    platform=entry["platform"],
                    epoch=int(entry["epoch"]),
                    storage=str(entry.get("storage", "")),
                )
            except (KeyError, TypeError, ValueError):
                dropped += 1
                continue
            # Invalidation contract: platform + epoch must match the
            # current process, or the entry is a different machine
            # class / settings generation.
            if (key.platform != platform_fingerprint()
                    or key.epoch != _settings.epoch):
                dropped += 1
                continue
            with self._lock:
                self._entries[key] = Verdict(
                    label=entry.get("label", ""),
                    timings_ms=dict(entry.get("timings_ms", {})),
                    trials=int(entry.get("trials", 0)),
                )
        _obs.inc("autotune.store.load")
        if dropped:
            _obs.event("autotune.store.dropped", count=dropped)
