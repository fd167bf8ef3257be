# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""legate_sparse_tpu_torch.obs: the observability core — counters,
spans, latency histograms, OpenMetrics export, memory watermarks and
the communication ledger.

The port's own copy of ``legate_sparse_tpu/obs`` (its ``counters``,
``trace``, ``latency``, ``export``, ``memory`` and ``comm``), under the
JAX package's names, so one dashboard or test reads both packages:

- ``counters`` — always-on process-wide counters (``op.*``,
  ``transfer.host_sync.*``, ``build.*``, ``scipy_fallback.*``) with a
  per-thread buffered fast path (``counters.handle``);
- ``trace`` — spans (``with obs.span("spmv", ...)``) and instant events,
  exported as newline-JSON or Chrome trace;
- ``latency`` — always-on ``lat.*`` histograms of host dispatch time;
- ``export`` — OpenMetrics text of the counters and histograms;
- ``memory`` — ``mem.*`` watermark events (RSS, the card's allocated
  bytes);
- ``comm`` — the collective byte formulas of the distribution layer;
- ``context`` — request-scoped trace ids that tag spans and draw the
  Chrome trace's flow arcs.

Enable tracing with ``LEGATE_SPARSE_TPU_OBS=1`` (read once at import),
``settings.obs = True`` or programmatically::

    from legate_sparse_tpu_torch import obs
    obs.enable()
    ...             # run the workload
    obs.write_chrome_trace("run.trace.json")

Disabled (the default) the span API is a no-op returning a shared null
context manager; counters and histograms stay live either way.  No
span, timer or counter synchronises with the card.
"""

from . import (  # noqa: F401
    comm, context, counters, export, latency, memory, trace,
)
from .counters import inc, snapshot  # noqa: F401
from .export import snapshot_openmetrics, write_openmetrics  # noqa: F401
from .latency import observe  # noqa: F401
from .trace import (  # noqa: F401
    complete_span, disable, enable, enabled, event, records, reset, span,
    to_chrome_trace, write_chrome_trace, write_jsonl,
)

__all__ = [
    "comm", "context", "counters", "export", "latency", "memory",
    "trace",
    "inc", "snapshot", "observe",
    "snapshot_openmetrics", "write_openmetrics",
    "complete_span", "enable", "disable", "enabled", "event", "records",
    "reset", "span", "to_chrome_trace", "write_chrome_trace",
    "write_jsonl",
]


def reset_all() -> None:
    """Drop buffered trace records and zero counters and histograms
    (test isolation, between phases)."""
    trace.reset()
    counters.reset()
    latency.reset()
