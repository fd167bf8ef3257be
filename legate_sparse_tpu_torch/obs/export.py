# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""OpenMetrics / Prometheus text export of counters and histograms.

The port's copy of ``legate_sparse_tpu/obs/export.py``: every
always-on ``counters`` value and every ``latency`` histogram rendered
as OpenMetrics text, a pure read of the snapshots.  The family names
and label layout are the JAX package's, so equal counters and
histograms render the same text in both packages:

- ``legate_sparse_tpu_counter_total{name="op.spmv"} 42`` — every
  counter, rendered as an OpenMetrics counter sample.
- ``legate_sparse_tpu_latency{name="lat.spmv.n4096", ...}`` — every
  histogram as a classic cumulative-bucket histogram (``_bucket`` with
  ascending ``le`` boundaries ending in ``+Inf``, plus ``_sum`` and
  ``_count``).  Bucket boundaries are the fixed log2 grid of
  :mod:`.latency`; only occupied buckets are emitted.

API::

    from legate_sparse_tpu_torch import obs
    text = obs.export.snapshot_openmetrics()     # the exposition text
    obs.export.write_openmetrics("metrics.prom") # snapshot-to-file
    counters, hists = obs.export.parse_openmetrics(text)

``LEGATE_SPARSE_TPU_OBS_PROM=<path>`` arms an atexit snapshot-to-file
(best effort: a failed write must never mask the process's real exit)
and a chaining SIGTERM handler that flushes the snapshot, restores the
prior disposition and re-raises, so a killed process still leaves the
artifact.  ``snapshot_openmetrics`` runs ``obs.slo.evaluate()`` first,
so an armed process publishes fresh ``slo.*`` counters with every
scrape; :func:`parse_openmetrics` is the inverse the doctor reads.
"""

from __future__ import annotations

import atexit
import os
import re
import signal
from typing import Dict, Optional, Tuple

from . import counters as _counters
from . import latency as _latency

ENV_PROM_FILE = "LEGATE_SPARSE_TPU_OBS_PROM"

_PREFIX = "legate_sparse_tpu"


def _escape_label(value: str) -> str:
    """OpenMetrics label-value escaping: backslash, quote, newline."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v) -> str:
    """Sample value: integers render bare (counter totals), floats in
    repr precision (no scientific-notation surprises for small ms)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


def render_openmetrics(
        counters_snap: Optional[Dict] = None,
        histograms: Optional[Dict[str, "_latency.Histogram"]] = None,
) -> str:
    """Render the given (or live) snapshots as OpenMetrics text,
    ``# EOF`` terminated.  Deterministic: families and samples are
    name-sorted."""
    if counters_snap is None:
        counters_snap = _counters.snapshot()
    if histograms is None:
        histograms = _latency.snapshot()
    lines = []

    lines.append(f"# TYPE {_PREFIX}_counter counter")
    lines.append(f"# HELP {_PREFIX}_counter Always-on process counters"
                 " (docs/OBSERVABILITY.md naming contract).")
    for name in sorted(counters_snap):
        lines.append(
            f'{_PREFIX}_counter_total{{name="{_escape_label(name)}"}} '
            f"{_fmt_value(counters_snap[name])}")

    lines.append(f"# TYPE {_PREFIX}_latency histogram")
    lines.append(f"# HELP {_PREFIX}_latency Streaming log2-bucket"
                 " histograms (obs/latency.py; ms unless the name says"
                 " otherwise).")
    for name in sorted(histograms):
        hist = histograms[name]
        label = _escape_label(name)
        acc = 0
        for slot, count in hist.nonzero_buckets():
            acc += count
            le = _latency.slot_upper(slot)
            lines.append(
                f'{_PREFIX}_latency_bucket{{name="{label}",'
                f'le="{_fmt_value(le)}"}} {acc}')
        lines.append(
            f'{_PREFIX}_latency_bucket{{name="{label}",le="+Inf"}} '
            f"{acc}")
        lines.append(f'{_PREFIX}_latency_sum{{name="{label}"}} '
                     f"{_fmt_value(hist.sum)}")
        lines.append(f'{_PREFIX}_latency_count{{name="{label}"}} '
                     f"{acc}")

    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def snapshot_openmetrics() -> str:
    """Live snapshot of all counters + histograms as OpenMetrics text
    (the scrape-path API).  Runs SLO evaluation first, so the text
    carries this scrape's ``slo.*`` verdict counters; one flag read
    while ``LEGATE_SPARSE_TPU_OBS_SLO`` is unset."""
    from . import slo as _slo

    _slo.evaluate()
    return render_openmetrics()


# Parsed sample lines of the two families rendered above.
_COUNTER_LINE_RE = re.compile(
    rf'^{_PREFIX}_counter_total\{{name="((?:[^"\\]|\\.)*)"\}} (\S+)$')
_LATENCY_LINE_RE = re.compile(
    rf'^{_PREFIX}_latency_(bucket|sum|count)'
    rf'\{{name="((?:[^"\\]|\\.)*)"(?:,le="([^"]*)")?\}} (\S+)$')


_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label(value: str) -> str:
    # One left-to-right pass — sequential str.replace would corrupt
    # ``\\n`` (escaped backslash + literal n) into a newline.
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPE_MAP.get(m.group(1), m.group(1)), value)


def parse_openmetrics(text: str) -> Tuple[Dict, Dict]:
    """Parse exposition text produced by :func:`render_openmetrics`
    back into ``(counters, histograms)`` — counters as ``{name:
    value}``, histograms as ``{name: {"buckets": [(le, cumulative),
    ...], "sum": float, "count": int}}``.  Unparseable non-comment
    lines raise (the format is pinned, not advisory)."""
    counts: Dict[str, float] = {}
    hists: Dict[str, Dict] = {}
    saw_eof = False
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            saw_eof = line.strip() == "# EOF"
            continue
        m = _COUNTER_LINE_RE.match(line)
        if m:
            name = _unescape_label(m.group(1))
            val = float(m.group(2))
            counts[name] = int(val) if val.is_integer() else val
            continue
        m = _LATENCY_LINE_RE.match(line)
        if m:
            kind, raw_name, le, raw = (m.group(1), m.group(2),
                                       m.group(3), m.group(4))
            name = _unescape_label(raw_name)
            h = hists.setdefault(
                name, {"buckets": [], "sum": 0.0, "count": 0})
            if kind == "bucket":
                bound = float("inf") if le == "+Inf" else float(le)
                h["buckets"].append((bound, int(raw)))
            elif kind == "sum":
                h["sum"] = float(raw)
            else:
                h["count"] = int(raw)
            continue
        raise ValueError(f"unparseable OpenMetrics line: {line!r}")
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    return counts, hists


def write_openmetrics(path: Optional[str] = None) -> str:
    """Write the live snapshot to ``path`` (default: the
    ``LEGATE_SPARSE_TPU_OBS_PROM`` env value).  Returns the path."""
    if path is None:
        path = os.environ.get(ENV_PROM_FILE)
    if not path:
        raise ValueError(
            f"write_openmetrics: no path given and {ENV_PROM_FILE} "
            f"is unset")
    text = snapshot_openmetrics()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)       # atomic vs a concurrent scraper read
    return path


def _atexit_snapshot() -> None:  # pragma: no cover - exercised via env
    try:
        write_openmetrics()
    except Exception:
        # Best effort by contract: a failed metrics write must never
        # mask the process's real exit status.
        pass


def _install_sigterm_flush() -> bool:  # pragma: no cover - subprocess
    """Chain a SIGTERM handler that flushes the snapshot, then defers
    to the prior disposition (default: restore it and re-kill, so the
    process still exits 143 and supervisors see a normal TERM death).
    Containerized runs are killed, not exited — atexit alone leaves no
    artifact there."""
    try:
        prev = signal.getsignal(signal.SIGTERM)
    except (ValueError, OSError):
        return False            # no signal support here

    def _on_sigterm(signum, frame):
        _atexit_snapshot()
        if callable(prev) and prev not in (signal.SIG_IGN,
                                           signal.SIG_DFL):
            prev(signum, frame)
            return
        signal.signal(signal.SIGTERM,
                      prev if prev is not None else signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        return False            # e.g. imported off the main thread
    return True


if os.environ.get(ENV_PROM_FILE):
    atexit.register(_atexit_snapshot)
    _install_sigterm_flush()
