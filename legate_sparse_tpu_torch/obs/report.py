# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Aggregation of trace records into a per-op table, and the ledger
tables (the port of ``legate_sparse_tpu/obs/report.py``: equal counters,
histograms or records render equal text in both packages).

Turns the raw span stream (``trace.records()`` / a trace file) into a
per-op table: call count, first-call time (structure builds and a
kernel's first launch), steady-state time, nnz/bytes/flops totals,
achieved GB/s from the steady-state time, and the roofline fraction
against a caller-given stream bandwidth.  Span times are host dispatch
times (no device sync).

Per-op GB/s uses STEADY-STATE time only: first calls carry the build,
and mixing them in is exactly the "build or kernel?" ambiguity this
subsystem exists to remove.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional


def load_records(path: str) -> List[Dict[str, Any]]:
    """Read trace records from a file in either export format
    (newline-JSON from ``write_jsonl`` or Chrome-trace from
    ``write_chrome_trace``).  Chrome events are mapped back to the
    native record shape."""
    with open(path) as f:
        text = f.read()
    text = text.strip()
    if not text:
        return []
    # Newline-JSON lines also start with "{": the whole-file parse
    # only succeeds for the Chrome document (or a 1-record jsonl).
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" not in doc:
        return [doc]        # single-record newline-JSON file
    if isinstance(doc, dict):
        out: List[Dict[str, Any]] = []
        for ev in doc.get("traceEvents", []):
            args = dict(ev.get("args") or {})
            rec: Dict[str, Any] = {
                "name": ev.get("name", "?"),
                "ts_ns": float(ev.get("ts", 0.0)) * 1e3,
                "tid": ev.get("tid", 0),
            }
            if ev.get("ph") == "X":
                rec["type"] = "span"
                rec["dur_ns"] = float(ev.get("dur", 0.0)) * 1e3
                rec["seq"] = args.pop("seq", 0)
                rec["first"] = bool(args.pop("first_call", rec["seq"] == 0))
            elif ev.get("ph") in ("s", "t", "f"):
                # Flow-arc anchors (obs v4 causal request flows): kept
                # as their own record type so the per-op aggregation
                # never mistakes them for instrumentation events.
                rec["type"] = "flow"
                rec["flow_id"] = ev.get("id")
            else:
                rec["type"] = "event"
            if args:
                rec["attrs"] = args
            out.append(rec)
        return out
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def aggregate(records: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Per-op rollup of span records (events are counted, not timed).

    Returns ``{name: {calls, events, total_ms, first_ms, steady_ms,
    steady_calls, nnz, bytes, flops, gbs, gflops}}``; ``steady_ms`` is
    the mean over non-first calls (None with < 2 calls), ``gbs`` the
    achieved bandwidth bytes/steady-time (None without bytes attrs)."""
    agg: Dict[str, Dict[str, Any]] = {}
    for r in records:
        if r.get("type") == "flow":
            continue            # arc anchors duplicate span timings
        name = r.get("name", "?")
        row = agg.setdefault(name, {
            "calls": 0, "events": 0, "total_ms": 0.0, "first_ms": None,
            "steady_total_ms": 0.0, "steady_calls": 0,
            "steady_nnz": 0, "steady_bytes": 0, "steady_flops": 0,
            "nnz": 0, "bytes": 0, "flops": 0,
        })
        if r.get("type") == "event":
            row["events"] += 1
            continue
        dur_ms = float(r.get("dur_ns", 0)) / 1e6
        row["calls"] += 1
        row["total_ms"] += dur_ms
        attrs = r.get("attrs") or {}
        nnz = attrs.get("nnz")
        nbytes = attrs.get("bytes")
        flops = attrs.get("flops")
        for key, val in (("nnz", nnz), ("bytes", nbytes), ("flops", flops)):
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                row[key] += val
        if r.get("first", r.get("seq", 0) == 0):
            # Several "first" spans can appear after a trace.reset();
            # keep the largest (the real compile is the slow one).
            if row["first_ms"] is None or dur_ms > row["first_ms"]:
                row["first_ms"] = dur_ms
        else:
            row["steady_total_ms"] += dur_ms
            row["steady_calls"] += 1
            for key, val in (("steady_nnz", nnz), ("steady_bytes", nbytes),
                             ("steady_flops", flops)):
                if isinstance(val, (int, float)) and not isinstance(val,
                                                                    bool):
                    row[key] += val
    for row in agg.values():
        n = row["steady_calls"]
        row["steady_ms"] = (row["steady_total_ms"] / n) if n else None
        t_s = row["steady_total_ms"] / 1e3
        row["gbs"] = (row["steady_bytes"] / t_s / 1e9
                      if t_s > 0 and row["steady_bytes"] else None)
        row["gflops"] = (row["steady_flops"] / t_s / 1e9
                         if t_s > 0 and row["steady_flops"] else None)
    return agg


def _fmt(val: Optional[float], pattern: str = "{:.3f}") -> str:
    if val is None:
        return "-"
    return pattern.format(val)


def _fmt_count(val: Any) -> str:
    if not val:
        return "-"
    v = float(val)
    for unit in ("", "K", "M", "G", "T"):
        if abs(v) < 1000:
            return (f"{v:.0f}{unit}" if unit == "" or abs(v) >= 10
                    else f"{v:.1f}{unit}")
        v /= 1000.0
    return f"{v:.1f}P"


def format_table(headers: List[str], rows: List[List[str]],
                 left_cols: int = 1) -> str:
    """Shared fixed-width table renderer: column widths from content,
    first ``left_cols`` columns left-aligned, the rest right-aligned,
    a dash rule under the header.  Used by the per-op table here and
    the regress/comm renderers — one place for the layout logic."""
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]

    def line(cells):
        return "  ".join(
            c.ljust(widths[i]) if i < left_cols else c.rjust(widths[i])
            for i, c in enumerate(cells)
        ).rstrip()

    out = [line(headers), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def render_table(agg: Dict[str, Dict[str, Any]],
                 stream_gbs: Optional[float] = None) -> str:
    """Pretty-print the aggregate as a fixed-width per-op table.
    ``stream_gbs`` (the measured roofline from bench.py) adds a
    ``vs_stream`` column: achieved fraction of the machine ceiling."""
    headers = ["op", "calls", "total_ms", "first_ms", "steady_ms",
               "nnz", "bytes", "GB/s"]
    if stream_gbs:
        headers.append("vs_stream")
    rows = []
    order = sorted(agg.items(), key=lambda kv: -kv[1]["total_ms"])
    for name, row in order:
        if row["calls"] == 0 and row["events"]:
            label = f"{name} (x{row['events']} events)"
            rows.append([label] + ["-"] * (len(headers) - 1))
            continue
        line = [
            name,
            str(row["calls"]),
            _fmt(row["total_ms"]),
            _fmt(row["first_ms"]),
            _fmt(row["steady_ms"], "{:.4f}"),
            _fmt_count(row["nnz"]),
            _fmt_count(row["bytes"]),
            _fmt(row["gbs"], "{:.2f}"),
        ]
        if stream_gbs:
            frac = (row["gbs"] / stream_gbs) if row["gbs"] else None
            line.append(_fmt(frac, "{:.3f}"))
        rows.append(line)
    return format_table(headers, rows)


def summarize(records: Iterable[Dict[str, Any]],
              stream_gbs: Optional[float] = None) -> str:
    """One-shot: aggregate + render."""
    return render_table(aggregate(records), stream_gbs=stream_gbs)


def render_plans_table(counters: Dict[str, Any]) -> str:
    """Per-plan table from the ``engine.plan.*`` counters (embedded in
    a Chrome-trace artifact or taken live from ``counters.snapshot``):
    one row per compiled plan — builds (XLA compiles), cache hits,
    executions — plus the aggregate hit/miss/eviction line and the
    executor's batching totals.  ``tools/trace_summary.py --plans``."""
    per_plan: Dict[str, Dict[str, float]] = {}
    for name, val in counters.items():
        if not name.startswith("engine.plan."):
            continue
        body = name[len("engine.plan."):]
        if body in ("hits", "misses", "evictions", "build_ms"):
            continue                      # aggregate counters
        pid, _, kind = body.rpartition(".")
        if kind not in ("hits", "builds", "execs") or not pid:
            continue
        per_plan.setdefault(
            pid, {"hits": 0, "builds": 0, "execs": 0})[kind] += val
    lines = []
    if per_plan:
        rows = [
            [pid, str(int(r["builds"])), str(int(r["hits"])),
             str(int(r["execs"]))]
            for pid, r in sorted(per_plan.items(),
                                 key=lambda kv: -kv[1]["execs"])
        ]
        lines.append(format_table(["plan", "builds", "hits", "execs"],
                                  rows))
    else:
        lines.append("no engine.plan.* counters recorded "
                     "(engine never dispatched?)")
    hits = counters.get("engine.plan.hits", 0)
    misses = counters.get("engine.plan.misses", 0)
    if hits or misses:
        total = hits + misses
        lines.append(
            f"plan cache: {int(hits)} hits / {int(misses)} misses "
            f"({hits / total:.1%} hit rate), "
            f"{counters.get('engine.plan.build_ms', 0):.0f} ms "
            f"compiling, "
            f"{int(counters.get('engine.plan.evictions', 0))} evictions"
        )
    subs = counters.get("engine.exec.submitted", 0)
    if subs:
        batches = counters.get("engine.exec.batches", 0)
        breqs = counters.get("engine.exec.batched_requests", 0)
        qns = counters.get("engine.exec.queue_ns", 0)
        lines.append(
            f"executor: {int(subs)} submitted, {int(batches)} batches "
            f"({breqs / max(batches, 1):.1f} reqs/batch), "
            f"queue latency {qns / max(breqs, 1) / 1e3:.0f} us/req, "
            f"{int(counters.get('engine.exec.inline', 0))} inline, "
            f"{int(counters.get('engine.exec.backpressure', 0))} "
            f"backpressure"
        )
    return "\n".join(lines)


def render_latency_table(histograms: Dict[str, Any]) -> str:
    """Histogram ledger table from serialized ``lat.*`` histograms
    (the ``histograms`` blob in a Chrome-trace artifact, or
    ``{name: h.to_dict()}`` from a live ``latency.snapshot()``):
    count / mean / p50 / p95 / p99 / max per op and shape bucket.
    ``tools/trace_summary.py --latency`` renders this."""
    from . import latency as _latency

    if not histograms:
        return ("no latency histograms recorded "
                "(no instrumented ops ran?)")
    rows = []
    for name in sorted(histograms):
        try:
            h = _latency.Histogram.from_dict(name, histograms[name])
        except ValueError:
            # Artifact from a build with a different bucket grid
            # (SUB): the distribution is unreadable, not zero.
            rows.append([name, "?"] + ["(incompatible grid)"]
                        + ["-"] * 4)
            continue
        if h.count == 0:
            continue
        rows.append([
            name,
            str(h.count),
            _fmt(h.mean, "{:.4f}"),
            _fmt(h.quantile(0.5), "{:.4f}"),
            _fmt(h.quantile(0.95), "{:.4f}"),
            _fmt(h.quantile(0.99), "{:.4f}"),
            _fmt(h.max(), "{:.4f}"),
        ])
    if not rows:
        return ("no latency histograms recorded "
                "(no instrumented ops ran?)")
    return format_table(
        ["histogram", "count", "mean", "p50", "p95", "p99", "max"],
        rows)


# Aggregate resil.retry.* counter names that are NOT per-site rollups.
_RESIL_RETRY_AGG = ("attempts", "exhausted", "backoff_ms",
                    "budget_exhausted")


def render_resil_table(counters: Dict[str, Any]) -> str:
    """Per-site resilience ledger from the ``resil.*`` counters
    (``tools/trace_summary.py --resil``; naming contract in
    docs/RESILIENCE.md): one row per site that saw any activity —
    injected faults, retries, breaker trips and short-circuits,
    fallback-ladder flips — plus summary lines for shedding,
    deadlines, backoff, budgets, and health verdicts."""
    per_site: Dict[str, Dict[str, float]] = {}

    def row(site: str) -> Dict[str, float]:
        return per_site.setdefault(site, {
            "faults": 0, "retries": 0, "trips": 0,
            "short_circuit": 0, "fallbacks": 0})

    for name, val in counters.items():
        if not name.startswith("resil."):
            continue
        body = name[len("resil."):]
        # Aggregate counters (resil.fault.injected, resil.breaker.
        # trips, ...) parse to an empty site below — the summary lines
        # carry them; only non-empty sites get table rows.
        if body.startswith("fault.") and body.endswith(".injected"):
            site = body[len("fault."):-len(".injected")]
            if site:
                row(site)["faults"] += val
        elif body.startswith("retry."):
            site = body[len("retry."):]
            if site and site not in _RESIL_RETRY_AGG:
                row(site)["retries"] += val
        elif body.startswith("breaker.") and body.endswith(".trips"):
            site = body[len("breaker."):-len(".trips")]
            if site:
                row(site)["trips"] += val
        elif (body.startswith("breaker.")
                and body.endswith(".short_circuit")):
            site = body[len("breaker."):-len(".short_circuit")]
            if site:
                row(site)["short_circuit"] += val
        elif (body.startswith("fallback.")
                and body != "fallback"):
            site = body[len("fallback."):]
            if site:
                row(site)["fallbacks"] += val
    lines = []
    if per_site:
        rows = [
            [site, str(int(r["faults"])), str(int(r["retries"])),
             str(int(r["trips"])), str(int(r["short_circuit"])),
             str(int(r["fallbacks"]))]
            for site, r in sorted(per_site.items())
        ]
        lines.append(format_table(
            ["site", "faults", "retries", "trips", "short_circ",
             "fallbacks"], rows))
    else:
        lines.append("no per-site resil.* counters recorded "
                     "(resilience never engaged?)")
    att = counters.get("resil.retry.attempts", 0)
    if att or counters.get("resil.retry.exhausted", 0):
        lines.append(
            f"retries: {int(att)} attempts, "
            f"{counters.get('resil.retry.backoff_ms', 0):.1f} ms "
            f"backing off, "
            f"{int(counters.get('resil.retry.exhausted', 0))} "
            f"exhausted, "
            f"{int(counters.get('resil.retry.budget_exhausted', 0))} "
            f"budget-dry"
        )
    shed = counters.get("resil.shed", 0)
    ddl = counters.get("resil.deadline.solver", 0)
    if shed or ddl:
        lines.append(
            f"shedding: {int(shed)} requests shed "
            f"({int(counters.get('resil.shed.engine.exec.queue', 0))} "
            f"at admission, "
            f"{int(counters.get('resil.shed.engine.exec.dispatch', 0))}"
            f" at flush), {int(ddl)} solver deadline expiries"
        )
    health = {k[len("resil.health."):]: v for k, v in counters.items()
              if k.startswith("resil.health.")
              and "." not in k[len("resil.health."):]}
    if health:
        lines.append("health: " + ", ".join(
            f"{int(v)} {cause}" for cause, v in sorted(health.items())))
    inj = counters.get("resil.fault.injected", 0)
    if inj:
        lines.append(
            f"faults: {int(inj)} injected, "
            f"{int(counters.get('resil.fault.trace_skipped', 0))} "
            f"trace-suppressed"
        )
    saves = counters.get("resil.ckpt.saves", 0)
    if saves or counters.get("resil.ckpt.restores", 0):
        lines.append(
            f"checkpoints: {int(saves)} saved "
            f"({int(counters.get('resil.ckpt.bytes', 0))} host bytes, "
            f"{counters.get('resil.ckpt.ms', 0):.1f} ms), "
            f"{int(counters.get('resil.ckpt.restores', 0))} restored"
        )
    rec = counters.get("resil.recovery.attempts", 0)
    if rec:
        lines.append(
            f"recoveries: {int(rec)} device losses, "
            f"{int(counters.get('resil.recovery.mesh_shrink', 0))} "
            f"mesh shrinks moving "
            f"{int(counters.get('resil.recovery.reshard_bytes', 0))} "
            f"reshard bytes, "
            f"{int(counters.get('resil.recovery.restored_iters', 0))} "
            f"iterations restored, "
            f"{int(counters.get('resil.recovery.succeeded', 0))} "
            f"solves completed"
        )
    abft = counters.get("resil.abft.checks", 0)
    if abft:
        lines.append(
            f"abft: {int(abft)} checksummed SpMVs, "
            f"{int(counters.get('resil.abft.mismatch', 0))} mismatches"
        )
    return "\n".join(lines)


# Rejection-reason vocabulary shared with outcomes.REJECT_REASONS
# (kept literal here: report renders artifacts from other builds).
_GW_REASONS = ("deadline_shed", "quota", "queue_full", "breaker")


def render_gateway_table(counters: Dict[str, Any]) -> str:
    """Per-tenant admission-gateway ledger from the ``gateway.*``
    counters (``tools/trace_summary.py --gateway``; naming contract in
    docs/OBSERVABILITY.md): one row per tenant that submitted anything
    — submitted / served / shed / error — plus summary lines for batch
    formation (dispatches, packed multi-matrix batches, occupancy),
    per-reason rejections, and degraded-mode inline serves."""
    per_tenant: Dict[str, Dict[str, float]] = {}
    for name, val in counters.items():
        if not name.startswith("gateway.tenant."):
            continue
        body = name[len("gateway.tenant."):]
        tenant, _, kind = body.rpartition(".")
        if not tenant or kind not in ("submitted", "served", "shed",
                                      "error"):
            continue
        per_tenant.setdefault(tenant, {
            "submitted": 0, "served": 0, "shed": 0, "error": 0,
        })[kind] += val
    lines = []
    if per_tenant:
        rows = [
            [t, str(int(r["submitted"])), str(int(r["served"])),
             str(int(r["shed"])), str(int(r["error"]))]
            for t, r in sorted(per_tenant.items(),
                               key=lambda kv: (-kv[1]["submitted"],
                                               kv[0]))
        ]
        lines.append(format_table(
            ["tenant", "submitted", "served", "shed", "error"], rows))
    else:
        lines.append("no gateway.tenant.* counters recorded "
                     "(gateway never engaged?)")
    subs = counters.get("gateway.submitted", 0)
    if subs:
        disp = counters.get("gateway.dispatches", 0)
        dreq = counters.get("gateway.dispatched_requests", 0)
        lines.append(
            f"gateway: {int(subs)} submitted, "
            f"{int(counters.get('gateway.admitted', 0))} admitted, "
            f"{int(disp)} dispatches "
            f"({dreq / max(disp, 1):.1f} reqs/batch, "
            f"{int(counters.get('gateway.packed', 0))} packed "
            f"multi-matrix), "
            f"{int(counters.get('gateway.inline', 0))} inline, "
            f"{int(counters.get('gateway.evicted', 0))} evicted"
        )
    rej = {r: counters.get(f"gateway.rejected.{r}", 0)
           for r in _GW_REASONS}
    if any(rej.values()):
        lines.append("rejections: " + ", ".join(
            f"{int(v)} {r}" for r, v in rej.items() if v))
    degraded = (counters.get("gateway.breaker_inline", 0)
                + counters.get("gateway.admit_fault_inline", 0)
                + counters.get("gateway.dispatch_fault_inline", 0)
                + counters.get("gateway.dispatch_fallback", 0))
    if degraded:
        lines.append(
            f"degraded serves: "
            f"{int(counters.get('gateway.breaker_inline', 0))} "
            f"breaker-inline, "
            f"{int(counters.get('gateway.admit_fault_inline', 0))} "
            f"admit-fault, "
            f"{int(counters.get('gateway.dispatch_fault_inline', 0))} "
            f"dispatch-fault, "
            f"{int(counters.get('gateway.dispatch_fallback', 0))} "
            f"dispatch-fallback"
        )
    return "\n".join(lines)


# Per-tenant attributed-cost kinds (obs/attrib.py naming contract).
_ATTRIB_KINDS = ("wall_ns", "wait_ns", "comm_bytes", "comm_calls",
                 "dispatches", "compiles", "mem_kb")


def render_tenants_table(counters: Dict[str, Any]) -> str:
    """Per-tenant attributed-cost ledger from the ``attrib.tenant.*``
    counters (``tools/trace_summary.py --tenants``; obs/attrib.py
    naming contract): one row per tenant with attributed dispatch
    busy time, queue wait, interconnect bytes/collective calls,
    dispatch/compile counts and watermark growth — plus the
    conservation line checking the attributed byte sum against the
    untagged ``comm.total_bytes`` ledger, and the utilization
    totals."""
    per_tenant: Dict[str, Dict[str, float]] = {}
    for name, val in counters.items():
        if not name.startswith("attrib.tenant."):
            continue
        body = name[len("attrib.tenant."):]
        tenant, _, kind = body.rpartition(".")
        if not tenant or kind not in _ATTRIB_KINDS:
            continue
        per_tenant.setdefault(
            tenant, {k: 0 for k in _ATTRIB_KINDS})[kind] += val
    lines = []
    if per_tenant:
        rows = [
            [t, f"{r['wall_ns'] / 1e6:.3f}", f"{r['wait_ns'] / 1e6:.3f}",
             str(int(r["comm_bytes"])), str(int(r["comm_calls"])),
             str(int(r["dispatches"])), str(int(r["compiles"])),
             str(int(r["mem_kb"]))]
            for t, r in sorted(per_tenant.items(),
                               key=lambda kv: (-kv[1]["wall_ns"],
                                               kv[0]))
        ]
        lines.append(format_table(
            ["tenant", "busy_ms", "wait_ms", "comm_bytes", "comm_calls",
             "dispatches", "compiles", "mem_kb"], rows))
    else:
        lines.append("no attrib.tenant.* counters recorded "
                     "(attribution off — LEGATE_SPARSE_TPU_OBS_ATTRIB "
                     "unset?)")
        return "\n".join(lines)
    attributed_b = sum(int(r["comm_bytes"]) for r in per_tenant.values())
    total_b = int(counters.get("attrib.total.comm_bytes", 0))
    ledger_b = int(counters.get("comm.total_bytes", 0))
    verdict = "exact" if attributed_b == total_b else "VIOLATED"
    lines.append(
        f"conservation: {attributed_b} attributed bytes vs "
        f"{total_b} attributed-window total ({verdict}); untagged "
        f"comm.total_bytes = {ledger_b}")
    busy = counters.get("util.busy_ns", 0)
    if busy:
        lines.append(
            f"utilization: {busy / 1e6:.3f} busy ms over "
            f"{int(counters.get('util.dispatches', 0))} dispatch "
            f"spans, {int(counters.get('capacity.reports', 0))} "
            f"capacity reports")
    folds = counters.get("attrib.fold.other", 0)
    if folds:
        lines.append(f"tenant cap: {int(folds)} labels folded into "
                     f"__other__")
    return "\n".join(lines)


def render_placement_table(counters: Dict[str, Any]) -> str:
    """Elastic-placement control-loop ledger from the ``placement.*``
    counters (``tools/trace_summary.py --placement``;
    legate_sparse_tpu_torch/placement naming contract): controller activity
    (steps/proposals and per-reason holds), migration work (count,
    declared reshard bytes, thrash), and the data-plane view (placed
    tenants, routed admissions, breaker-degraded serves)."""
    placement = {name[len("placement."):]: val
                 for name, val in counters.items()
                 if name.startswith("placement.")}
    if not placement:
        return ("no placement.* counters recorded (placement off — "
                "LEGATE_SPARSE_TPU_PLACEMENT unset?)")
    lines = []
    holds = sorted((k[len("hold."):], int(v))
                   for k, v in placement.items()
                   if k.startswith("hold.") and v)
    hold_s = ", ".join(f"{n} {r}" for r, n in holds) if holds else "none"
    lines.append(
        f"controller: {int(placement.get('steps', 0))} steps, "
        f"{int(placement.get('proposals', 0))} proposals, "
        f"holds: {hold_s}, "
        f"{int(placement.get('watchdog.ticks', 0))} watchdog ticks")
    lines.append(
        f"migrations: {int(placement.get('migrations', 0))} applied, "
        f"{int(placement.get('migration.bytes', 0))} declared reshard "
        f"bytes (priced == measured: comm.dist_reshard.ppermute_bytes"
        f" = {int(counters.get('comm.dist_reshard.ppermute_bytes', 0))}"
        f"), {int(placement.get('thrash', 0))} thrash")
    lines.append(
        f"data plane: {int(placement.get('placed', 0))} tenants "
        f"placed, {int(placement.get('routes', 0))} routed "
        f"admissions, {int(placement.get('degraded_serve', 0))} "
        f"breaker-degraded serves, "
        f"{int(placement.get('shrink.flagged', 0))} shrink flags")
    return "\n".join(lines)


def render_delta_table(counters: Dict[str, Any]) -> str:
    """Streaming-mutation ledger from the ``delta.*`` counters
    (``tools/trace_summary.py --delta``; legate_sparse_tpu_torch/delta
    naming contract, docs/MUTATION.md): buffer activity (update
    batches, applied/overwritten slots, the derived still-pending
    count), compaction work (merges, bytes, version swaps, watermark
    pressure) and the serving view (two-term serves, gateway routes,
    distributed comm pricing)."""
    delta = {name[len("delta."):]: val
             for name, val in counters.items()
             if name.startswith("delta.")}
    if not delta:
        return ("no delta.* counters recorded (delta off — "
                "LEGATE_SPARSE_TPU_DELTA unset?)")
    applied = int(delta.get("applied", 0))
    merged = int(delta.get("compaction.merged", 0))
    lines = []
    lines.append(
        f"buffer: {int(delta.get('updates', 0))} update batches, "
        f"{applied} slots applied, "
        f"{int(delta.get('overwrites', 0))} overwrites, "
        f"{max(applied - merged, 0)} pending")
    lines.append(
        f"compaction: {int(delta.get('compactions', 0))} runs, "
        f"{merged} entries merged, "
        f"{int(delta.get('compaction.bytes', 0))} fresh-base bytes, "
        f"{int(delta.get('swap.versions', 0))} version swaps, "
        f"{int(delta.get('watermark.exceeded', 0))} watermark "
        f"exceedances, {int(delta.get('worker.errors', 0))} worker "
        f"errors")
    lines.append(
        f"serving: {int(delta.get('served', 0))} two-term serves, "
        f"{int(delta.get('routes', 0))} routed admissions, "
        f"comm: {int(counters.get('comm.delta.scatter_bytes', 0))} "
        f"scatter bytes, "
        f"{int(counters.get('comm.delta.all_gather_bytes', 0))} "
        f"all_gather bytes")
    return "\n".join(lines)


def render_flows_table(records: Iterable[Dict[str, Any]]) -> str:
    """Per-request causal-flow ledger (``tools/trace_summary.py
    --flows``): one row per trace id found in span ``trace_id`` /
    ``trace_ids`` attrs — span count, the span names bracketing the
    arc, and the end-to-end wall time from first span start to last
    span end.  Batch spans carry every member's id in ``trace_ids``,
    so one grouped dispatch legitimately appears in several flows."""
    flows: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        if r.get("type") != "span":
            continue
        attrs = r.get("attrs") or {}
        ids = []
        tid = attrs.get("trace_id")
        if isinstance(tid, str):
            ids.append(tid)
        tids = attrs.get("trace_ids")
        if isinstance(tids, (list, tuple)):
            ids.extend(t for t in tids if isinstance(t, str))
        for t in ids:
            flows.setdefault(t, []).append(r)
    if not flows:
        return ("no trace-tagged spans recorded "
                "(tracing off, or no gateway/engine requests?)")
    rows = []
    for fid in sorted(flows):
        spans = sorted(flows[fid], key=lambda s: s.get("ts_ns", 0.0))
        t0 = spans[0].get("ts_ns", 0.0)
        t1 = max(s.get("ts_ns", 0.0) + s.get("dur_ns", 0.0)
                 for s in spans)
        busy_ms = sum(s.get("dur_ns", 0.0) for s in spans) / 1e6
        rows.append([
            fid,
            str(len(spans)),
            spans[0].get("name", "?"),
            spans[-1].get("name", "?"),
            _fmt((t1 - t0) / 1e6),
            _fmt(busy_ms),
        ])
    return format_table(
        ["flow", "spans", "first", "last", "wall_ms", "busy_ms"],
        rows, left_cols=4)


def render_slo_table(counters: Dict[str, Any],
                     records: Iterable[Dict[str, Any]] = ()) -> str:
    """SLO burn ledger (``tools/trace_summary.py --slo``): one row per
    SLO seen in ``slo.verdict`` events (latest verdict wins) or in the
    ``slo.breach.*`` counter ledger, plus an evaluation-cadence summary
    line.  Renders artifacts — no live registry access — so it works
    on traces from other processes."""
    latest: Dict[str, Dict[str, Any]] = {}
    for r in records:
        if r.get("type") != "event" or r.get("name") != "slo.verdict":
            continue
        attrs = r.get("attrs") or {}
        slo_name = attrs.get("slo")
        if isinstance(slo_name, str):
            latest[slo_name] = attrs
    breaches = {name[len("slo.breach."):]: val
                for name, val in counters.items()
                if name.startswith("slo.breach.")}
    names = sorted(set(latest) | set(breaches))
    lines = []
    if names:
        rows = []
        for n in names:
            a = latest.get(n, {})
            rows.append([
                n,
                str(a.get("status", "breach" if breaches.get(n)
                          else "?")),
                _fmt(a.get("objective_ms"), "{:.0f}"),
                (f"{a.get('fast_bad')}/{a.get('fast_total')}"
                 if a.get("fast_total") is not None else "-"),
                _fmt(a.get("fast_burn"), "{:.1f}"),
                _fmt(a.get("slow_burn"), "{:.1f}"),
                str(int(breaches.get(n, 0))),
            ])
        lines.append(format_table(
            ["slo", "status", "obj_ms", "fast_bad", "fast_burn",
             "slow_burn", "breaches"], rows, left_cols=2))
    else:
        lines.append("no slo.* activity recorded "
                     "(LEGATE_SPARSE_TPU_OBS_SLO unset, or no "
                     "evaluations ran?)")
    evals = counters.get("slo.evaluations", 0)
    if evals:
        lines.append(
            f"evaluations: {int(evals)} "
            f"({int(counters.get('slo.watchdog.ticks', 0))} from the "
            f"watchdog), "
            f"{int(sum(breaches.values()))} total breaches")
    return "\n".join(lines)
