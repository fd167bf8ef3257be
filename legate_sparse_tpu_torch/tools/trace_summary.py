# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Pretty-print a trace file as a per-op table (the port of
``tools/trace_summary.py`` over ``obs/report.py``; same flags, same
text, same exit status).

Reads either export format (Chrome-trace ``*.trace.json`` from
``bench_torch.py`` / ``obs.write_chrome_trace``, or newline-JSON from
``obs.write_jsonl``) and renders the per-op aggregation: calls,
total/first-call/steady-state time, nnz and bytes totals, achieved
GB/s, and, given the measured stream bandwidth, the fraction of it
each op reaches.

Usage::

    python -m legate_sparse_tpu_torch.tools.trace_summary BENCH_20261018T120000.trace.json
    python -m legate_sparse_tpu_torch.tools.trace_summary run.trace.json --stream-gbs 3000
    python -m legate_sparse_tpu_torch.tools.trace_summary run.trace.json --events --counters
    python -m legate_sparse_tpu_torch.tools.trace_summary run.trace.json --comm --autotune
    python -m legate_sparse_tpu_torch.tools.trace_summary run.trace.json --gateway --latency

``--stream-gbs`` defaults to the ``stream_gbs`` recorded in the trace
file's bench metadata when present (``bench_torch.py`` embeds its
result).  Exit status: 2 when the file contains no span records.  It
reads files only: no device is touched.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs import report


def render_comm_table(counters: dict) -> str:
    """Per-op x collective table from the ``comm.*`` ledger counters
    embedded in a Chrome-trace artifact: collective-op count and
    predicted interconnect bytes (obs/comm.py accounting convention:
    total across the mesh, counted once at each receiver)."""
    rows = {}
    by_layout = {}
    for name, val in counters.items():
        if not name.startswith("comm.") or name.startswith("comm.total"):
            continue
        body = name[len("comm."):]
        is_bytes = body.endswith("_bytes")
        if is_bytes:
            body = body[: -len("_bytes")]
        if body.startswith("layout."):
            # comm.layout.<layout>.<op>[_bytes] aggregates: grouped in
            # their own by-layout section, not the flat table (they
            # would double-count the per-collective rows).
            layout, _, op = body[len("layout."):].partition(".")
            row = by_layout.setdefault((layout, op),
                                       {"calls": 0, "bytes": 0})
            row["bytes" if is_bytes else "calls"] += val
            continue
        op, _, coll = body.rpartition(".")
        row = rows.setdefault((op, coll), {"calls": 0, "bytes": 0})
        row["bytes" if is_bytes else "calls"] += val
    if not rows:
        return "no comm.* counters recorded (no distributed ops ran?)"
    headers = ["op", "collective", "calls", "bytes", "MB"]
    lines = []
    for (op, coll), row in sorted(rows.items(),
                                  key=lambda kv: -kv[1]["bytes"]):
        lines.append([op, coll, str(int(row["calls"])),
                      str(int(row["bytes"])),
                      f"{row['bytes'] / 2**20:.3f}"])
    total_b = sum(r["bytes"] for r in rows.values())
    total_c = sum(r["calls"] for r in rows.values())
    lines.append(["TOTAL", "", str(int(total_c)), str(int(total_b)),
                  f"{total_b / 2**20:.3f}"])
    out = report.format_table(headers, lines, left_cols=2)
    if by_layout:
        lay_headers = ["layout", "op", "calls", "bytes", "MB"]
        lay_lines = []
        for (layout, op), row in sorted(by_layout.items(),
                                        key=lambda kv: -kv[1]["bytes"]):
            lay_lines.append([layout, op, str(int(row["calls"])),
                              str(int(row["bytes"])),
                              f"{row['bytes'] / 2**20:.3f}"])
        out += ("\n\nby layout (partition strategy):\n"
                + report.format_table(lay_headers, lay_lines,
                                      left_cols=2))
    return out


def render_autotune_table(counters: dict) -> str:
    """Routing/measurement ledger from the ``autotune.*`` counters
    embedded in a Chrome-trace artifact: verdict store activity, the
    route hit/miss/decline funnel, and per-kernel routed-dispatch
    counts (the dynamic ``autotune.route.<label>`` rows)."""
    rows = {name: val for name, val in counters.items()
            if name.startswith("autotune.")}
    if not rows:
        return ("no autotune.* counters recorded (autotuner off — "
                "LEGATE_SPARSE_TPU_AUTOTUNE unset?)")
    headers = ["counter", "value"]
    lines = [[name, str(int(val))] for name, val in sorted(rows.items())]
    return report.format_table(headers, lines, left_cols=1)


def render_graph_table(counters: dict) -> str:
    """Graph-analytics ledger from the ``graph.*`` counters embedded
    in a Chrome-trace artifact: per-algorithm runs/iteration totals
    and the per-semiring distributed dispatch counts
    (``graph.dist_spmv.<semiring>`` / ``graph.dist_spmm.<semiring>`` /
    ``graph.matvec.<semiring>`` rows)."""
    rows = {name: val for name, val in counters.items()
            if name.startswith("graph.")}
    if not rows:
        return ("no graph.* counters recorded (no "
                "legate_sparse_tpu.graph algorithm or semiring "
                "dispatch ran)")
    headers = ["counter", "value"]
    lines = [[name, str(int(val))] for name, val in sorted(rows.items())]
    return report.format_table(headers, lines, left_cols=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-op table from a legate_sparse_tpu_torch trace "
                    "file."
    )
    ap.add_argument("trace_file", help="Chrome-trace or newline-JSON file")
    ap.add_argument("--stream-gbs", type=float, default=None,
                    help="measured stream (triad) bandwidth for the "
                         "vs_stream roofline column; defaults to the "
                         "value embedded by bench_torch.py when present")
    ap.add_argument("--events", action="store_true",
                    help="also list instant events (probe failures, "
                         "layout decisions, window declines)")
    ap.add_argument("--counters", action="store_true",
                    help="also dump the counter snapshot embedded in a "
                         "Chrome-trace file")
    ap.add_argument("--comm", action="store_true",
                    help="also render the comm.* ledger (per-op x "
                         "collective calls + predicted interconnect "
                         "bytes)")
    ap.add_argument("--plans", action="store_true",
                    help="also render the engine plan-cache table "
                         "(per-plan builds/hits/execs + executor "
                         "batching totals from the engine.* counters)")
    ap.add_argument("--resil", action="store_true",
                    help="also render the resilience ledger (per-site "
                         "faults/retries/breaker activity, shedding, "
                         "health verdicts from the resil.* counters)")
    ap.add_argument("--gateway", action="store_true",
                    help="also render the admission-gateway ledger "
                         "(per-tenant submitted/served/shed/error, "
                         "batch formation, per-reason rejections from "
                         "the gateway.* counters)")
    ap.add_argument("--autotune", action="store_true",
                    help="also render the autotune ledger (verdict "
                         "store activity, route hit/miss/decline "
                         "funnel, per-kernel routed dispatches from "
                         "the autotune.* counters)")
    ap.add_argument("--flows", action="store_true",
                    help="also render the causal-flow ledger (one row "
                         "per request trace id: span count, bracketing "
                         "span names, end-to-end wall time — obs v4 "
                         "flow arcs)")
    ap.add_argument("--slo", action="store_true",
                    help="also render the SLO burn ledger (latest "
                         "verdict per objective from slo.verdict "
                         "events + the exact slo.breach.* counters)")
    ap.add_argument("--graph", action="store_true",
                    help="also render the graph-analytics ledger "
                         "(per-algorithm runs/iters and per-semiring "
                         "distributed dispatch counts from the "
                         "graph.* counters)")
    ap.add_argument("--tenants", action="store_true",
                    help="also render the per-tenant attribution "
                         "ledger (attributed busy/wait time, comm "
                         "bytes, dispatch/compile counts and the "
                         "conservation check from the attrib.* "
                         "counters)")
    ap.add_argument("--placement", action="store_true",
                    help="also render the elastic-placement ledger "
                         "(controller steps/holds, migration count "
                         "and declared reshard bytes, routed "
                         "admissions from the placement.* counters)")
    ap.add_argument("--delta", action="store_true",
                    help="also render the streaming-mutation ledger "
                         "(update batches, applied/pending slots, "
                         "compaction merges and version swaps, comm "
                         "pricing from the delta.* counters)")
    ap.add_argument("--latency", action="store_true",
                    help="also render the latency-histogram ledger "
                         "(count/p50/p95/p99/max per op and shape "
                         "bucket from the lat.* histograms embedded "
                         "in a Chrome-trace artifact)")
    args = ap.parse_args(argv)

    records = report.load_records(args.trace_file)
    spans = [r for r in records if r.get("type") == "span"]

    stream_gbs = args.stream_gbs
    meta = {}
    try:
        with open(args.trace_file) as f:
            doc = json.load(f)
        if isinstance(doc, dict):
            meta = doc.get("otherData", {}) or {}
            if stream_gbs is None:
                stream_gbs = (meta.get("bench_result") or {}).get(
                    "stream_gbs")
    except (ValueError, OSError):
        pass  # newline-JSON / unreadable: no embedded metadata

    if not spans:
        print(f"{args.trace_file}: no span records "
              f"({len(records)} events total) — was tracing enabled "
              f"(LEGATE_SPARSE_TPU_OBS=1)?", file=sys.stderr)
        return 2

    print(report.render_table(report.aggregate(records),
                              stream_gbs=stream_gbs))

    if args.events:
        events = [r for r in records if r.get("type") == "event"]
        if events:
            print(f"\nevents ({len(events)}):")
            for r in events:
                attrs = r.get("attrs") or {}
                detail = " ".join(f"{k}={v}" for k, v in attrs.items())
                print(f"  {r['name']}  {detail}".rstrip())

    if args.counters and meta.get("counters"):
        print("\ncounters:")
        for name in sorted(meta["counters"]):
            print(f"  {name} = {meta['counters'][name]}")

    if args.comm:
        print("\ncomm ledger:")
        print(render_comm_table(meta.get("counters") or {}))

    if args.plans:
        print("\nengine plans:")
        print(report.render_plans_table(meta.get("counters") or {}))

    if args.resil:
        print("\nresilience ledger:")
        print(report.render_resil_table(meta.get("counters") or {}))

    if args.gateway:
        print("\ngateway ledger:")
        print(report.render_gateway_table(meta.get("counters") or {}))

    if args.autotune:
        print("\nautotune ledger:")
        print(render_autotune_table(meta.get("counters") or {}))

    if args.graph:
        print("\ngraph ledger:")
        print(render_graph_table(meta.get("counters") or {}))

    if args.tenants:
        print("\ntenant attribution:")
        print(report.render_tenants_table(meta.get("counters") or {}))

    if args.placement:
        print("\nplacement ledger:")
        print(report.render_placement_table(meta.get("counters") or {}))

    if args.delta:
        print("\ndelta ledger:")
        print(report.render_delta_table(meta.get("counters") or {}))

    if args.flows:
        print("\ncausal flows:")
        print(report.render_flows_table(records))

    if args.slo:
        print("\nslo ledger:")
        print(report.render_slo_table(meta.get("counters") or {},
                                      records))

    if args.latency:
        print("\nlatency histograms:")
        print(report.render_latency_table(meta.get("histograms") or {}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
