# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Automated performance doctor: offline diagnosis over obs artifacts
(the port of the repo's ``tools/doctor.py``, reading the port's own
``obs.export``, ``obs.regress`` and ``obs.report``).

Point it at any mix of the three artifact kinds the port emits —

- Chrome-trace JSON (``obs.write_chrome_trace``; the ``otherData`` blob
  carries counters, histograms and, where a caller adds one, a bench
  result),
- OpenMetrics text (``LEGATE_SPARSE_TPU_OBS_PROM`` snapshots,
  ``obs.export.write_openmetrics``),
- bench result JSON (a result object, a ``{"n", "parsed"}`` wrapper,
  a log tail)

— and it cross-references them into a ranked findings table: SLO
budget burns, noisy neighbors, migration thrash, compaction lag,
rebuilding with the delta layer off, breaker trips, recoveries without
checkpoints, plan-cache thrash, autotune declines, storage wider than
its verdict, batch occupancy collapse, comm-bytes drift, roofline
shortfall, gateway rejection pressure, observability overhead and
dropped records.  Every finding carries a remediation hint.  Given the
same artifacts it gives ``tools/doctor.py``'s findings in its order.
The JAX package's planverify artifacts (StableHLO contracts, a TPU
compilation check) are not read: such a file is reported unreadable.

Artifact kind is auto-detected from content, never from the filename.

Usage::

    python -m legate_sparse_tpu_torch.obs.doctor run.trace.json metrics.prom
    python -m legate_sparse_tpu_torch.obs.doctor --check evidence/BENCH_golden_smoke.json
    python -m legate_sparse_tpu_torch.obs.doctor --check --fail-on warn a.json

``--check`` makes the exit status a CI verdict: 1 when any finding at
or above ``--fail-on`` severity (default ``critical``) is present,
0 otherwise, 2 when no artifact could be read.  Without ``--check``
the exit status is always 0 (report, don't judge).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from . import export, regress, report

SEVERITIES = ("info", "warn", "critical")

# Thresholds (module constants so tests can reference them).
PLAN_HIT_RATE_FLOOR = 0.5
BATCH_OCCUPANCY_FLOOR = 2.0
COMM_DELTA_TOL = 0.01
ROOFLINE_FLOOR = 0.7
GATEWAY_REJECT_CEIL = 0.10
OBS_OVERHEAD_CEIL_PCT = 5.0
# A tenant holding more than this share of attributed device time is
# a noisy-neighbor candidate; the finding fires only while some SLO
# burns at page level (the obs/slo.py fast-window breach threshold).
NOISY_NEIGHBOR_SHARE = 0.5
SLO_PAGE_BURN = 14.4
# Same-shape-bucket COO->CSR rebuild count at which a workload looks
# like streaming mutation being served by full reconstruction — the
# delta-disabled-but-rebuilding evidence (docs/MUTATION.md).
COO_REBUILD_FLOOR = 3


def _severity_rank(sev: str) -> int:
    return SEVERITIES.index(sev)


class Evidence:
    """Merged view over every artifact read: counters (summed across
    artifacts — each is a monotone ledger of its own process), the
    latest histograms, the latest bench result, and all trace
    records."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.histograms: Dict[str, Any] = {}
        self.bench: Dict[str, Any] = {}
        self.records: List[Dict[str, Any]] = []
        self.sources: List[str] = []

    def add_counters(self, counters: Dict[str, Any]) -> None:
        for name, val in counters.items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                self.counters[name] = self.counters.get(name, 0) + val

    def counter(self, name: str, default: float = 0.0) -> float:
        return self.counters.get(name, default)

    def field(self, name: str, default=None):
        """Bench-result field lookup."""
        val = self.bench.get(name, default)
        return default if val is None else val


def load_artifact(path: str, ev: Evidence) -> str:
    """Read one artifact into the evidence, returning the detected
    kind (``openmetrics`` / ``trace`` / ``bench``).  Raises ValueError
    when the content matches none of them, and for a planverify
    artifact."""
    with open(path) as f:
        text = f.read()
    stripped = text.strip()
    if stripped.startswith(f"# TYPE {export._PREFIX}") or \
            f"{export._PREFIX}_counter_total" in stripped.split("\n", 3)[0]:
        counters, hists = export.parse_openmetrics(text)
        ev.add_counters(counters)
        ev.histograms.update(hists)
        ev.sources.append(f"{path} (openmetrics)")
        return "openmetrics"
    try:
        doc = json.loads(stripped)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        ev.records.extend(report.load_records(path))
        meta = doc.get("otherData") or {}
        ev.add_counters(meta.get("counters") or {})
        ev.histograms.update(meta.get("histograms") or {})
        bench = meta.get("bench_result")
        if isinstance(bench, dict):
            ev.bench.update(bench)
        ev.sources.append(f"{path} (trace)")
        return "trace"
    if isinstance(doc, dict) and doc.get("tool") == "planverify":
        raise ValueError("planverify artifacts check the JAX package's "
                         "StableHLO contracts; the port does not read them")
    bench = regress.load_bench(path)      # raises ValueError if not one
    ev.bench.update(bench)
    ev.sources.append(f"{path} (bench)")
    return "bench"


def _finding(sev: str, code: str, message: str, hint: str,
             value: Optional[str] = None) -> Dict[str, str]:
    return {"severity": sev, "code": code, "message": message,
            "hint": hint, "value": value or "-"}


def _parse_verdict_key(key_id: str):
    """Split a ``VerdictKey.key_id`` —
    ``op/dtype/fp_class/rN/zN/kN[/sTAG]@platform/eN`` — into
    ``(op, dtype, fp_class, shape-bucket tuple)``, or None when the id
    doesn't parse.  The optional ``/s`` storage tag and the
    platform/epoch suffix are deliberately excluded: the
    storage-wider-than-verdict rule compares *structural* identity
    across storage representations."""
    head = key_id.split("@", 1)[0]
    parts = head.split("/")
    if parts and parts[-1][:1] == "s":
        parts = parts[:-1]
    if len(parts) < 6:
        return None
    shape = tuple(parts[-3:])
    if [t[:1] for t in shape] != ["r", "z", "k"]:
        return None
    return parts[0], parts[1], "/".join(parts[2:-3]), shape


def diagnose(ev: Evidence) -> List[Dict[str, str]]:
    """Run every rule over the merged evidence; findings ranked
    critical-first, stable within severity (rule order)."""
    out: List[Dict[str, str]] = []

    # -- SLO budget burns: the one signal that is a page, not a smell.
    breaches = {name[len("slo.breach."):]: val
                for name, val in ev.counters.items()
                if name.startswith("slo.breach.") and val}
    for slo_name in sorted(breaches):
        out.append(_finding(
            "critical", "slo-breach",
            f"SLO '{slo_name}' burned its error budget "
            f"{int(breaches[slo_name])}x (fast-window burn >= page "
            f"threshold)",
            "docs/OBSERVABILITY.md 'SLO registry': inspect "
            "trace_summary --slo, then the lat.* histograms behind "
            "the objective",
            str(int(breaches[slo_name]))))

    # -- Noisy neighbor: one tenant monopolizes the attributed device
    #    time (obs/attrib.py ledger) while some SLO burns at page
    #    level — the capacity signal the submesh-carving actuator
    #    (ROADMAP item 2) exists for.
    wall: Dict[str, float] = {}
    for name, val in ev.counters.items():
        if (name.startswith("attrib.tenant.")
                and name.endswith(".wall_ns")):
            tenant = name[len("attrib.tenant."):-len(".wall_ns")]
            if tenant not in ("__untagged__", "__other__"):
                wall[tenant] = wall.get(tenant, 0) + val
    total_wall = sum(wall.values())
    burning = bool(breaches)
    if not burning:
        for rec in ev.records:
            if (rec.get("type") == "event"
                    and rec.get("name") == "slo.verdict"
                    and float((rec.get("attrs") or {})
                              .get("fast_burn", 0.0)) >= SLO_PAGE_BURN):
                burning = True
                break
    if total_wall > 0 and len(wall) >= 2 and burning:
        hog, hog_ns = max(wall.items(), key=lambda kv: (kv[1], kv[0]))
        share = hog_ns / total_wall
        if share > NOISY_NEIGHBOR_SHARE:
            out.append(_finding(
                "warn", "noisy-neighbor",
                f"tenant '{hog}' holds {share:.0%} of attributed "
                f"device time while an SLO burns at page level",
                "docs/OBSERVABILITY.md 'Per-tenant attribution': "
                "carve the hog a dedicated submesh (reshard(), "
                "ROADMAP item 2) or tighten its gateway rate/quota "
                "knobs",
                f"{share:.2f}"))
            # The actuator for exactly this smell exists
            # (legate_sparse_tpu_torch/placement); if no placement.* counter
            # moved in the evidence, the control loop that would carve
            # the hog its own submesh never ran.
            if not any(n.startswith("placement.")
                       for n in ev.counters):
                out.append(_finding(
                    "info", "placement-disabled-while-noisy-neighbor",
                    "a noisy-neighbor burns an SLO but the elastic "
                    "placement controller is off (no placement.* "
                    "counters in the evidence)",
                    "set LEGATE_SPARSE_TPU_PLACEMENT=1 and drive "
                    "PlacementController.step() (docs/PLACEMENT.md) "
                    "so the hog is carved a dedicated submesh "
                    "automatically",
                    "-"))

    # -- Migration thrash: the placement controller re-migrated a
    #    tenant within its own cooldown without the tenant's burn
    #    improving — the control loop is oscillating, not converging.
    thrash = ev.counter("placement.thrash")
    if thrash:
        out.append(_finding(
            "warn", "migration-thrash",
            f"placement controller re-migrated a still-burning tenant "
            f"within cooldown {int(thrash)}x (oscillating, not "
            f"converging)",
            "raise LEGATE_SPARSE_TPU_PLACEMENT_COOLDOWN_MS or "
            "LEGATE_SPARSE_TPU_PLACEMENT_AMORTIZE so migrations must "
            "pay for themselves; inspect trace_summary --placement",
            str(int(thrash))))

    # -- Compaction lagging: the delta side-buffer crossed its
    #    watermark while some SLO burns at page level — every serve
    #    pays the two-term dispatch on a near-full buffer instead of
    #    the merged base, and mutation pressure is outrunning the
    #    background merge.
    wm = ev.counter("delta.watermark.exceeded")
    if wm and burning:
        out.append(_finding(
            "warn", "compaction-lagging",
            f"delta buffer crossed its compaction watermark "
            f"{int(wm)}x while an SLO burns at page level (mutation "
            f"pressure outrunning the background merge)",
            "lower LEGATE_SPARSE_TPU_DELTA_WATERMARK (compact "
            "earlier) or arm/shorten LEGATE_SPARSE_TPU_DELTA_"
            "WORKER_MS (docs/MUTATION.md); inspect trace_summary "
            "--delta",
            str(int(wm))))

    # -- Rebuilding what the delta layer would serve: repeated
    #    same-shape-bucket COO->CSR constructions with the delta flag
    #    off — the workload is mutating by full reconstruction, the
    #    exact cost the side-buffer + background-compaction path
    #    amortizes away.
    if not any(n.startswith("delta.") for n in ev.counters):
        rebuilds = {name[len("build.csr.coo."):]: val
                    for name, val in ev.counters.items()
                    if name.startswith("build.csr.coo.")
                    and val >= COO_REBUILD_FLOOR}
        if rebuilds:
            bucket, n = max(rebuilds.items(),
                            key=lambda kv: (kv[1], kv[0]))
            out.append(_finding(
                "info", "delta-disabled-but-rebuilding",
                f"{int(n)} same-shape COO->CSR rebuilds (bucket "
                f"{bucket}) with the delta layer off — mutation "
                f"served by full reconstruction",
                "set LEGATE_SPARSE_TPU_DELTA=1 and serve updates "
                "through DeltaCSR.update() + background compaction "
                "(docs/MUTATION.md) instead of rebuilding",
                str(int(n))))

    # -- Breaker trips: capacity was protected by failing fast.
    trips = ev.counter("resil.breaker.trips") or ev.field(
        "resil_breaker_trips", 0)
    if trips:
        out.append(_finding(
            "warn", "breaker-trips",
            f"circuit breaker tripped {int(trips)}x — downstream "
            f"failures crossed the trip threshold",
            "docs/RESILIENCE.md: check resil.breaker.*.trips sites "
            "via trace_summary --resil; raise capacity or fix the "
            "failing dependency before tuning thresholds",
            str(int(trips))))

    # -- Recovery without checkpoint advance: device losses were
    #    survived, but every recovery restarted from scratch (or from
    #    one stale snapshot) — the checkpoint cadence is off or far
    #    coarser than the loss rate, so restored work is being lost.
    recoveries = ev.counter("resil.recovery.attempts") or ev.field(
        "resil_recoveries", 0)
    ck_saves = ev.counter("resil.ckpt.saves") or ev.field(
        "resil_ckpt_saves", 0)
    if recoveries and not ck_saves:
        out.append(_finding(
            "warn", "recovery-without-checkpoint-advance",
            f"{int(recoveries)} device-loss recoveries ran with zero "
            f"checkpoint saves — every recovery restarted from x0",
            "docs/RESILIENCE.md: set LEGATE_SPARSE_TPU_RESIL_CKPT_"
            "ITERS (or open checkpoint.scope) so restores resume "
            "from a recent iterate instead of replaying the solve",
            str(int(recoveries))))

    # -- Plan-cache thrash: every miss is an XLA recompile.
    hits = ev.counter("engine.plan.hits") or ev.field(
        "engine_plan_hits", 0)
    misses = ev.counter("engine.plan.misses") or ev.field(
        "engine_plan_misses", 0)
    if hits + misses:
        rate = hits / (hits + misses)
        if rate < PLAN_HIT_RATE_FLOOR:
            out.append(_finding(
                "warn", "plan-thrash",
                f"engine plan-cache hit rate {rate:.0%} (< "
                f"{PLAN_HIT_RATE_FLOOR:.0%}) — shape churn is forcing "
                f"recompiles",
                "docs/ENGINE.md: widen pad buckets "
                "(LEGATE_SPARSE_TPU_ENGINE knobs) or raise the plan "
                "cache capacity",
                f"{rate:.2f}"))

    # -- Autotune decline ladder: measurements that never pay off.
    at_declines = ev.counter("autotune.route.declined")
    at_hits = ev.counter("autotune.route.hit")
    if at_declines and at_declines > at_hits:
        out.append(_finding(
            "warn", "autotune-declines",
            f"autotuner declined routing {int(at_declines)}x vs "
            f"{int(at_hits)} routed hits — measured verdicts are not "
            f"being reused",
            "docs/AUTOTUNER.md: check the decline ladder "
            "(autotune.route.* counters); stale store? "
            "LEGATE_SPARSE_TPU_AUTOTUNE_STORE path writable?",
            str(int(at_declines))))

    # -- Storage wider than verdict: the autotuner measured a
    #    bf16-storage winner for a fingerprint class, yet f32 storage
    #    of the same class is still being tuned/dispatched — the
    #    compressed-storage byte win is sitting idle.
    bf16_classes: Dict[tuple, str] = {}
    f32_classes: Dict[tuple, str] = {}
    for rec in ev.records:
        if rec.get("name") != "autotune.verdict":
            continue
        attrs = rec.get("attrs") or {}
        parsed = _parse_verdict_key(str(attrs.get("key", "")))
        if parsed is None:
            continue
        op, dtype, klass, shape = parsed
        if dtype in ("bfloat16", "float16"):
            bf16_classes[(op, klass, shape)] = str(
                attrs.get("label", "?"))
        elif dtype == "float32":
            f32_classes[(op, klass, shape)] = str(attrs.get("key"))
    for group in sorted(set(bf16_classes) & set(f32_classes)):
        op, klass, shape = group
        out.append(_finding(
            "warn", "storage-wider-than-verdict",
            f"f32 storage is being dispatched for {op}/{klass}/"
            f"{'/'.join(shape)} although a compressed-storage verdict "
            f"({bf16_classes[group]!r}) exists for the same "
            f"fingerprint class — the measured byte win is sitting "
            f"idle",
            "csr_array.compress() the operand (bf16 values + int16 "
            "indices) so the *-bf16 verdict serves the dispatch "
            "(docs/AUTOTUNER.md 'Candidates'); keep f32 storage only "
            "where the rounding is unacceptable",
            f32_classes[group]))

    # -- Batch occupancy: a batching engine running solo requests.
    for label, breq, batches in (
            ("executor", ev.counter("engine.exec.batched_requests"),
             ev.counter("engine.exec.batches")),
            ("gateway", ev.counter("gateway.dispatched_requests"),
             ev.counter("gateway.dispatches"))):
        if batches >= 4 and breq / batches < BATCH_OCCUPANCY_FLOOR:
            out.append(_finding(
                "info", "batch-occupancy",
                f"{label} batch occupancy {breq / batches:.1f} "
                f"reqs/batch over {int(batches)} batches (< "
                f"{BATCH_OCCUPANCY_FLOOR:.0f}) — batching overhead "
                f"without batching wins",
                "docs/ENGINE.md: raise the batch window "
                "(_ENGINE_WINDOW_US) or submit concurrently; solo "
                "streams may prefer inline dispatch",
                f"{breq / batches:.1f}"))

    # -- Comm bytes, counted vs bench-recorded: drift means the
    #    predictive model and the dist kernels disagree.
    counted = ev.counter("comm.total_bytes")
    recorded = ev.field("comm_total_bytes")
    if counted and isinstance(recorded, (int, float)) and recorded:
        delta = abs(counted - recorded) / recorded
        if delta > COMM_DELTA_TOL:
            out.append(_finding(
                "warn", "comm-drift",
                f"comm.total_bytes counter ({int(counted)}) vs bench "
                f"comm_total_bytes ({int(recorded)}) differ "
                f"{delta:.1%} (> {COMM_DELTA_TOL:.0%})",
                "docs/DIST.md accounting contract: a dist kernel "
                "changed its collective pattern without updating "
                "obs/comm.py predictions (or vice versa)",
                f"{delta:.3f}"))

    # -- CPU roofline shortfall, with the measured loss terms ranked.
    ratio = ev.field("cpu_roofline_ratio")
    if isinstance(ratio, (int, float)) and ratio < ROOFLINE_FLOOR:
        items = ev.field("cpu_roofline_items") or {}
        ranked = sorted(
            ((k, v) for k, v in items.items()
             if isinstance(v, (int, float))),
            key=lambda kv: -kv[1])
        detail = ", ".join(f"{k}={v:.2f}" for k, v in ranked[:3])
        out.append(_finding(
            "warn", "roofline-shortfall",
            f"cpu_roofline_ratio {ratio:.2f} (< {ROOFLINE_FLOOR}) — "
            f"SpMV is leaving measured bandwidth on the table"
            + (f"; top losses: {detail}" if detail else ""),
            "bench.py itemizes the loss terms "
            "(cpu_roofline_items); attack the largest first "
            "(mask/pad losses -> layout, segment-sum -> kernel)",
            f"{ratio:.2f}"))

    # -- Gateway rejection pressure.
    submitted = ev.counter("gateway.submitted") or ev.field(
        "gateway_requests", 0)
    rejected = sum(v for name, v in ev.counters.items()
                   if name.startswith("gateway.rejected."))
    if not rejected:
        rejected = sum(
            v for k, v in ev.bench.items()
            if k.startswith("gateway_rejected_")
            and isinstance(v, (int, float)))
    if submitted and rejected / submitted > GATEWAY_REJECT_CEIL:
        out.append(_finding(
            "warn", "gateway-rejections",
            f"gateway rejected {int(rejected)}/{int(submitted)} "
            f"submissions ({rejected / submitted:.0%} > "
            f"{GATEWAY_REJECT_CEIL:.0%}) — admission pressure exceeds "
            f"capacity",
            "docs/OBSERVABILITY.md gateway ledger: split by reason "
            "(trace_summary --gateway); queue_full -> raise "
            "queue/quota knobs, breaker -> see breaker-trips",
            f"{rejected / submitted:.2f}"))

    # -- Observability overhead.  Smoke-lane artifacts are excluded:
    #    the CI toy matrix runs SpMV in microseconds, so the relative
    #    span tax there is dominated by the probe itself and would
    #    flap the otherwise-deterministic finding set.
    overhead = ev.field("obs_overhead_pct")
    if isinstance(overhead, (int, float)) and \
            not ev.field("smoke", False) and \
            overhead > OBS_OVERHEAD_CEIL_PCT:
        out.append(_finding(
            "warn", "obs-overhead",
            f"obs_overhead_pct {overhead:.1f}% (> "
            f"{OBS_OVERHEAD_CEIL_PCT:.0f}%) — tracing is taxing the "
            f"hot path",
            "run with LEGATE_SPARSE_TPU_OBS unset in production; "
            "spans are the only toggled cost (counters/histograms "
            "are always-on by design)",
            f"{overhead:.1f}"))

    # -- Dropped records: the trace itself is lying by omission.
    dropped = ev.counter("obs.dropped_records")
    if dropped:
        out.append(_finding(
            "info", "trace-dropped",
            f"{int(dropped)} trace records dropped at the MAX_RECORDS "
            f"cap — per-op tables undercount",
            "docs/OBSERVABILITY.md: reset/export the trace "
            "periodically, or trace a shorter window",
            str(int(dropped))))

    out.sort(key=lambda f: -_severity_rank(f["severity"]))
    return out


def render_findings(findings: List[Dict[str, str]],
                    verbose_hints: bool = True) -> str:
    if not findings:
        return "doctor: no findings — all ledgers within thresholds"
    rows = [[f["severity"].upper(), f["code"], f["value"], f["message"]]
            for f in findings]
    out = [report.format_table(
        ["severity", "finding", "value", "detail"], rows, left_cols=4)]
    if verbose_hints:
        out.append("")
        for f in findings:
            out.append(f"[{f['code']}] hint: {f['hint']}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m legate_sparse_tpu_torch.obs.doctor",
        description="Ranked diagnosis over obs artifacts (Chrome "
                    "trace / OpenMetrics / bench JSON).")
    ap.add_argument("artifacts", nargs="+",
                    help="artifact files; kind auto-detected from "
                         "content")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: exit 1 when any finding reaches "
                         "--fail-on severity")
    ap.add_argument("--fail-on", choices=SEVERITIES, default="critical",
                    help="minimum severity that fails --check "
                         "(default: critical)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array instead of "
                         "the table")
    ap.add_argument("--no-hints", action="store_true",
                    help="omit the remediation-hint lines")
    args = ap.parse_args(argv)

    ev = Evidence()
    for path in args.artifacts:
        try:
            kind = load_artifact(path, ev)
        except (OSError, ValueError) as exc:
            print(f"doctor: cannot read {path}: {exc}", file=sys.stderr)
            continue
        print(f"doctor: read {path} ({kind})", file=sys.stderr)
    if not ev.sources:
        print("doctor: no readable artifacts", file=sys.stderr)
        return 2

    findings = diagnose(ev)
    if args.json:
        print(json.dumps(findings, indent=2))
    else:
        print(render_findings(findings,
                              verbose_hints=not args.no_hints))

    if args.check:
        floor = _severity_rank(args.fail_on)
        if any(_severity_rank(f["severity"]) >= floor
               for f in findings):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
