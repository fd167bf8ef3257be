# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Phase memory watermarks: ``mem.*`` events around phases.

The port's copy of ``legate_sparse_tpu/obs/memory.py``.  Wrap a phase
in ``with memory.watermark("spgemm")`` and the trace gains a
``mem.spgemm`` instant event carrying RSS before/after, the process
peak RSS, the card's allocated bytes where there is a card, and —
opt-in via ``LEGATE_SPARSE_TPU_OBS_TRACEMALLOC=1`` — the Python-heap
peak across the phase from ``tracemalloc``.

Watermarks follow the span overhead contract: while tracing is disabled
``watermark`` is a no-op — one module-global check, no /proc read.

Sampling sources, best-effort (a missing source drops its keys, never
the event):

- ``/proc/self/status`` ``VmRSS``/``VmHWM`` (Linux; exact, cheap);
  fallback ``resource.getrusage`` ``ru_maxrss`` (peak only).
- ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` summed
  over the visible CUDA devices (the JAX package reads
  ``jax.local_devices()[i].memory_stats()``).  Without a CUDA device no
  device keys are emitted, as the JAX package emits none where its
  backend is silent.  Reading them does not synchronise.
- ``tracemalloc.get_traced_memory()`` when tracing is active.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import threading

from . import trace as _trace

_TRACEMALLOC_ENV = "LEGATE_SPARSE_TPU_OBS_TRACEMALLOC"
_tls = threading.local()        # per-thread watermark nesting depth


def _rss_mb() -> Dict[str, float]:
    """Current and peak RSS in MiB (Linux /proc, resource fallback)."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_mb"] = round(int(line.split()[1]) / 1024, 2)
                elif line.startswith("VmHWM:"):
                    out["peak_rss_mb"] = round(
                        int(line.split()[1]) / 1024, 2)
    except OSError:
        pass
    if "peak_rss_mb" not in out:
        try:
            import resource
            import sys

            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss is kilobytes on Linux but BYTES on macOS —
            # and macOS is exactly where the /proc path above missed.
            div = 2**20 if sys.platform == "darwin" else 1024
            out["peak_rss_mb"] = round(peak / div, 2)
        except Exception:
            pass
    return out


def _device_mb() -> Dict[str, float]:
    """Allocated and peak-allocated bytes summed over the visible CUDA
    devices, in MiB (PyTorch's caching allocator's counts).  No CUDA
    device: no keys (absence means "no card", not 0)."""
    out: Dict[str, float] = {}
    try:
        import torch

        if not torch.cuda.is_available():
            return out
        in_use = peak = 0
        for i in range(torch.cuda.device_count()):
            in_use += int(torch.cuda.memory_allocated(i))
            peak += int(torch.cuda.max_memory_allocated(i))
        out["device_mb"] = round(in_use / 2**20, 2)
        out["device_peak_mb"] = round(peak / 2**20, 2)
    except (ImportError, RuntimeError):
        pass
    return out


def snapshot() -> Dict[str, float]:
    """One memory sample: RSS + peak RSS, device stats where exposed,
    tracemalloc current/peak when active."""
    out = _rss_mb()
    out.update(_device_mb())
    try:
        import tracemalloc

        if tracemalloc.is_tracing():
            cur, peak = tracemalloc.get_traced_memory()
            out["pyheap_mb"] = round(cur / 2**20, 2)
            out["pyheap_peak_mb"] = round(peak / 2**20, 2)
    except Exception:
        pass
    return out


class watermark:
    """Context manager recording a ``mem.<name>`` instant event at
    phase exit with before/after/peak memory attrs (plus any static
    ``attrs`` given at entry — e.g. a predicted allocation size).
    No-op while tracing is disabled."""

    __slots__ = ("name", "attrs", "_before", "_active")

    def __init__(self, name: str, **attrs: Any):
        self.name = name
        self.attrs = attrs
        self._before: Optional[Dict[str, float]] = None
        self._active = False

    def __enter__(self) -> "watermark":
        if not _trace.enabled():
            return self
        self._active = True
        _tls.depth = getattr(_tls, "depth", 0) + 1
        if os.environ.get(_TRACEMALLOC_ENV, "") not in ("", "0"):
            try:
                import tracemalloc

                if not tracemalloc.is_tracing():
                    tracemalloc.start()
                # Only the OUTERMOST watermark resets the peak: an
                # inner phase resetting it would erase allocation peaks
                # the enclosing phase already saw.  Inner watermarks
                # therefore report "peak since the outermost enclosing
                # watermark began" — a superset, never an undercount.
                if _tls.depth == 1:
                    tracemalloc.reset_peak()
            except Exception:
                pass
        self._before = snapshot()
        return self

    def set(self, **attrs: Any) -> "watermark":
        """Attach attrs discovered while the phase runs (e.g. the
        realized output nnz)."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._active:
            return
        _tls.depth = max(getattr(_tls, "depth", 1) - 1, 0)
        after = snapshot()
        ev: Dict[str, Any] = dict(self.attrs)
        before = self._before or {}
        for k, v in before.items():
            ev[f"{k}_before"] = v
        for k, v in after.items():
            ev[f"{k}_after"] = v
        if "rss_mb" in before and "rss_mb" in after:
            ev["rss_delta_mb"] = round(after["rss_mb"] - before["rss_mb"],
                                       2)
        if exc_type is not None:
            # An OOM-adjacent failure is exactly when the watermark
            # matters most: record the error class with the numbers.
            ev["error"] = exc_type.__name__
        _trace.event(f"mem.{self.name}", **ev)


# Convenience alias matching the phase vocabulary.
phase = watermark
