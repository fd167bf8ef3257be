# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's SLO evaluator, ledger tables and bench comparator
(``obs/slo.py``, ``obs/report.py``, ``obs/regress.py``) against the JAX
package's: the SLO and report cases of ``tests/test_obs_v4.py`` (its
context and OpenMetrics cases live in ``test_torch_obs.py``, its doctor
cases in ``test_torch_doctor.py``) and
``tests/test_delta.py::test_render_delta_table``, one for one.

Tolerance: exact.  Both packages see the same latency observations and
give the same verdicts; every renderer returns the JAX renderer's text
for the same counters, histograms or records (the port's own artifacts
and the JAX package's, each rendered by both); ``regress`` gives the
same findings and tables on the repo's bench rounds.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from utils_test.torch_ops_ranks import random_sp, tridiag_sp, xnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KNOBS = ("gateway", "resil", "resil_backoff_ms", "obs_attrib", "obs_slo",
          "obs_slo_watchdog_ms", "placement", "delta")


class Pkg:
    def __init__(self, name):
        self.name = name
        if name == "jax":
            import legate_sparse_tpu as sparse
            from legate_sparse_tpu import engine, obs, resilience
            from legate_sparse_tpu.settings import settings
        else:
            import legate_sparse_tpu_torch as sparse
            from legate_sparse_tpu_torch import engine, obs, resilience
            from legate_sparse_tpu_torch.settings import settings
        self.sparse, self.engine, self.obs = sparse, engine, obs
        self.resil, self.settings = resilience, settings
        self.slo, self.report, self.regress = obs.slo, obs.report, obs.regress
        self.latency, self.counters = obs.latency, obs.counters
        self.context, self.export = obs.context, obs.export

    def csr(self, S):
        if self.name == "jax":
            return self.sparse.csr_array(S)
        return self.sparse.csr_array(S, device="cpu")

    def x(self, n, seed=1):
        v = xnp(n, seed)
        return jnp.asarray(v) if self.name == "jax" else torch.from_numpy(v)

    def gateway(self, **kw):
        base = dict(max_batch=64, queue_depth=128, tenant_quota=64,
                    rate=0.0, burst=16.0, slack_ms=1.0, timeout_ms=0.0)
        base.update(kw)
        return self.engine.Gateway(self.engine.Engine(), **base)


def _reset(p):
    p.obs.reset_all()
    p.obs.trace.disable()
    p.context.reset_ids()
    p.resil.reset()


@pytest.fixture(scope="module")
def pkgs():
    return {"jax": Pkg("jax"), "torch": Pkg("torch")}


@pytest.fixture(autouse=True)
def _isolation(pkgs):
    from legate_sparse_tpu_torch import runtime

    runtime.set_device("cpu")
    saved = {n: {k: getattr(p.settings, k) for k in _KNOBS}
             for n, p in pkgs.items()}
    for p in pkgs.values():
        _reset(p)
    yield
    for n, p in pkgs.items():
        for k, v in saved[n].items():
            setattr(p.settings, k, v)
        p.slo.stop_watchdog()
        _reset(p)
    runtime.set_device(None)


def both(pkgs, case):
    return case(pkgs["jax"]), case(pkgs["torch"])


def slo_on(p):
    p.settings.obs_slo = True
    p.settings.obs_slo_watchdog_ms = 0.0


# ------------------------------------------------------------ SLO burn --

def test_slo_breach_exact_counter(pkgs):
    """``test_obs_v4.py::test_slo_breach_exact_counter``: the same
    verdicts and exact breach counter in both packages."""
    def case(p):
        slo_on(p)
        p.slo.register(p.slo.Slo("drill", "drill.op", None, "lat.drill.",
                                 objective_ms=1.0, target=0.99))
        for _ in range(8):
            p.latency.observe("lat.drill.op", 50.0)
        v1 = {v.slo: tuple(v) for v in p.slo.evaluate()}["drill"]
        b1 = p.counters.get("slo.breach.drill")
        v2 = {v.slo: tuple(v) for v in p.slo.evaluate()}["drill"]
        return (v1, b1, v2, p.counters.get("slo.breach.drill"),
                p.counters.get("slo.evaluations"))

    jx, pt = both(pkgs, case)
    assert pt == jx
    v1, b1, v2, b2, evals = pt
    assert v1[3] == "breach" and v1[6] == v1[7] == 8
    assert v1[8] == pytest.approx((8 / 8) / 0.01)
    assert (b1, v2[3], v2[6], b2, evals) == (1, "watch", 0, 1, 2)


def test_slo_ok_below_objective(pkgs):
    """``::test_slo_ok_below_objective``."""
    def case(p):
        slo_on(p)
        p.slo.register(p.slo.Slo("calm", "calm.op", None, "lat.calm.",
                                 objective_ms=1000.0))
        for _ in range(10):
            p.latency.observe("lat.calm.op", 0.5)
        (v,) = [tuple(v) for v in p.slo.evaluate() if v.slo == "calm"]
        return v, p.counters.get("slo.breach.calm")

    jx, pt = both(pkgs, case)
    assert pt == jx
    assert pt[0][3] == "ok" and pt[0][7] == 0 and pt[1] == 0


def test_slo_verdicts_equal_on_fuzzed_observations(pkgs):
    """Seeded latency observations (log-uniform over 1 us .. 10 s, into
    every default objective's histograms and a registered one), fed to
    both packages over three evaluation windows: equal verdicts."""
    rng = np.random.default_rng(5)
    names = ["lat.gateway.request.interactive",
             "lat.gateway.request.batch",
             "lat.gateway.request.background",
             "lat.engine.request.r4096", "lat.graph.bfs",
             "lat.graph.pagerank", "lat.fuzz.op"]
    windows = [[(names[int(rng.integers(len(names)))],
                 float(10 ** rng.uniform(-3, 4)))
                for _ in range(int(rng.integers(0, 300)))]
               for _ in range(3)]

    def case(p):
        slo_on(p)
        p.slo.register(p.slo.Slo("fuzz", "fuzz.op", None, "lat.fuzz.",
                                 objective_ms=3.0, target=0.9,
                                 min_events=5))
        out = []
        for obs_window in windows:
            for name, ms in obs_window:
                p.latency.observe(name, ms)
            out.append([tuple(v) for v in p.slo.evaluate()])
        return out, p.counters.snapshot("slo.")

    jx, pt = both(pkgs, case)
    assert pt == jx


def test_slo_latency_fault_drill_breaches_gateway_objective(pkgs):
    """``::test_slo_latency_fault_drill_breaches_gateway_objective``: an
    injected admission latency drives real ``lat.gateway.request.
    interactive`` observations past a tightened objective."""
    def case(p):
        slo_on(p)
        p.settings.gateway = p.settings.resil = True
        p.resil.reset()
        p.slo.register(p.slo.Slo(
            "gateway.interactive", "gateway.request", "interactive",
            "lat.gateway.request.interactive", objective_ms=1e-3,
            target=0.99))
        p.resil.faults.inject("gateway.admit", kind="latency", count=3,
                              latency_ms=5.0)
        gw = p.gateway()
        A = p.csr(random_sp())
        try:
            futs = [gw.submit(A, p.x(400, seed=s), tenant="t0",
                              qos="interactive") for s in range(3)]
            gw.flush()
            for f in futs:
                f.result()
        finally:
            gw.shutdown()
            p.resil.faults.clear()
        v = {v.slo: v for v in p.slo.evaluate()}["gateway.interactive"]
        return (v.status, v.fast_bad, v.fast_total,
                p.counters.get("slo.breach.gateway.interactive"))

    jx, pt = both(pkgs, case)
    assert pt == jx
    assert pt[0] == "breach" and pt[1] == pt[2] >= 3 and pt[3] == 1


def test_slo_inert_by_default(pkgs):
    """``::test_slo_inert_by_default``: unset, ``evaluate`` returns
    ``[]``, no ``slo.*`` counter exists, the scrape text carries none,
    and arming it changes no result."""
    def case(p):
        assert p.settings.obs_slo is False
        p.settings.gateway = True
        for _ in range(5):
            p.latency.observe("lat.gateway.request.interactive", 1e6)
        assert p.slo.evaluate() == [] and p.slo.verdicts() == []
        assert p.slo.start_watchdog(10.0) is False
        gw = p.gateway()
        A, x = p.csr(random_sp()), p.x(400)
        try:
            fut = gw.submit(A, x, tenant="t", qos="interactive")
            gw.flush()
            y_off = np.asarray(fut.result())
            assert not [k for k in p.counters.snapshot()
                        if k.startswith("slo.")]
            assert "slo." not in p.export.snapshot_openmetrics()
            p.settings.obs_slo = True
            p.export.snapshot_openmetrics()
            fut = gw.submit(A, x, tenant="t", qos="interactive")
            gw.flush()
            y_on = np.asarray(fut.result())
        finally:
            p.settings.obs_slo = False
            gw.shutdown()
        np.testing.assert_array_equal(y_off, y_on)
        return y_off

    jx, pt = both(pkgs, case)
    np.testing.assert_array_equal(pt, jx)


def test_slo_watchdog_ticks_and_stops(pkgs):
    """``::test_slo_watchdog_ticks_and_stops`` (the port's side; the
    thread's cadence is a clock, not a value to hold equal)."""
    p = pkgs["torch"]
    slo_on(p)
    p.slo.register(p.slo.Slo("wd", "wd.op", None, "lat.wd.",
                             objective_ms=1000.0))
    p.latency.observe("lat.wd.op", 0.1)
    assert p.slo.start_watchdog(5.0) is True
    assert p.slo.start_watchdog(5.0) is True
    deadline = time.monotonic() + 5.0
    while (p.counters.get("slo.watchdog.ticks") < 2
           and time.monotonic() < deadline):
        time.sleep(0.01)
    p.slo.stop_watchdog()
    ticks = p.counters.get("slo.watchdog.ticks")
    assert ticks >= 2
    assert p.counters.get("slo.evaluations") >= ticks
    time.sleep(0.05)
    assert p.counters.get("slo.watchdog.ticks") == ticks


def test_slo_register_replaces_and_resets(pkgs):
    """``::test_slo_register_replaces_and_resets``."""
    def case(p):
        p.slo.register(p.slo.Slo(
            "gateway.interactive", "gateway.request", "interactive",
            "lat.gateway.request.interactive", objective_ms=1.0))
        before = {s.name: s.objective_ms for s in p.slo.registered()}
        p.slo.reset()
        after = {s.name: s.objective_ms for s in p.slo.registered()}
        return before["gateway.interactive"], after

    jx, pt = both(pkgs, case)
    assert pt == jx
    assert pt[0] == 1.0 and pt[1]["gateway.interactive"] == 50.0


# ----------------------------------------------------- flow/slo tables --

def test_load_records_maps_flow_phases(pkgs, tmp_path):
    """``::test_load_records_maps_flow_phases``: each package's trace,
    read back by both packages' ``load_records``, gives the same
    records, and flow anchors stay out of the per-op aggregate."""
    def case(p):
        p.obs.enable()
        c = p.context.mint()
        with p.context.use(c):
            with p.obs.span("a"):
                pass
            with p.obs.span("b"):
                pass
        path = tmp_path / f"{p.name}.json"
        json.dump(p.obs.to_chrome_trace(), open(path, "w"))
        return c.trace_id, str(path)

    for trace_id, path in both(pkgs, case):
        recs = pkgs["torch"].report.load_records(path)
        assert recs == pkgs["jax"].report.load_records(path)
        assert {"flow", "span"} <= {r["type"] for r in recs}
        assert all(r["flow_id"] == trace_id for r in recs
                   if r["type"] == "flow")
        agg = pkgs["torch"].report.aggregate(recs)
        assert agg == pkgs["jax"].report.aggregate(recs)
        assert "request" not in agg and agg["a"]["calls"] == 1


_FLOW_RECORDS = [
    {"type": "span", "name": "gateway.admit", "ts_ns": 0, "dur_ns": 2e6,
     "attrs": {"trace_id": "req-1"}},
    {"type": "span", "name": "gateway.batch", "ts_ns": 3e6, "dur_ns": 4e6,
     "attrs": {"trace_ids": ["req-1", "req-2"]}},
    {"type": "span", "name": "gateway.admit", "ts_ns": 1e6, "dur_ns": 1e6,
     "attrs": {"trace_id": "req-2"}},
]


def test_render_flows_table_groups_by_trace_id(pkgs):
    """``::test_render_flows_table_groups_by_trace_id``: equal text."""
    jx, pt = both(pkgs, lambda p: (p.report.render_flows_table(
        _FLOW_RECORDS), p.report.render_flows_table([])))
    assert pt == jx
    row1 = next(ln for ln in pt[0].splitlines() if ln.startswith("req-1"))
    assert row1.split()[1] == "2" and "7.000" in row1
    assert pt[1].startswith("no trace-tagged spans")


def test_render_slo_table_from_events_and_counters(pkgs):
    """``::test_render_slo_table_from_events_and_counters``."""
    records = [{"type": "event", "name": "slo.verdict",
                "attrs": {"slo": "gateway.interactive", "status": "breach",
                          "objective_ms": 50.0, "fast_bad": 6,
                          "fast_total": 6, "fast_burn": 1000.0,
                          "slow_burn": 900.0}}]
    ctrs = {"slo.breach.gateway.interactive": 2, "slo.evaluations": 4}
    jx, pt = both(pkgs, lambda p: (p.report.render_slo_table(ctrs, records),
                                   p.report.render_slo_table({}, [])))
    assert pt == jx
    assert "breach" in pt[0] and "evaluations: 4" in pt[0]
    assert pt[1].startswith("no slo.* activity")


def test_trace_summary_flows_and_slo_flags(pkgs, tmp_path):
    """``::test_trace_summary_flows_and_slo_flags``, its report half: a
    gateway request under an armed SLO, written as a Chrome trace; the
    flows and SLO tables of that file are the JAX renderers' text."""
    p = pkgs["torch"]
    slo_on(p)
    p.settings.gateway = True
    p.obs.enable()
    p.slo.register(p.slo.Slo(
        "gateway.interactive", "gateway.request", "interactive",
        "lat.gateway.request.interactive", objective_ms=1e-6))
    gw = p.gateway()
    try:
        fut = gw.submit(p.csr(random_sp()), p.x(400), tenant="t0",
                        qos="interactive")
        gw.flush()
        fut.result()
    finally:
        gw.shutdown()
    p.slo.evaluate()
    path = str(tmp_path / "run.trace.json")
    p.obs.write_chrome_trace(path)
    ctrs = json.load(open(path))["otherData"]["counters"]
    jr, tr = pkgs["jax"].report, p.report
    recs = tr.load_records(path)
    flows = tr.render_flows_table(recs)
    assert flows == jr.render_flows_table(recs) and "req-" in flows
    table = tr.render_slo_table(ctrs, recs)
    assert table == jr.render_slo_table(ctrs, recs)
    assert "gateway.interactive" in table


def test_obs_overhead_rides_trajectory_ungated(pkgs):
    """``::test_obs_overhead_rides_trajectory_ungated``."""
    for p in pkgs.values():
        assert "obs_overhead_pct" in p.regress.TRAJECTORY_FIELDS
        assert p.regress._gated("obs_overhead_pct", 11.0) is None
    assert pkgs["torch"].regress.TRAJECTORY_FIELDS == \
        pkgs["jax"].regress.TRAJECTORY_FIELDS


def test_render_delta_table(pkgs):
    """``test_delta.py::test_render_delta_table``: equal text."""
    ctrs = {"delta.updates": 11, "delta.applied": 101,
            "delta.overwrites": 2, "delta.compactions": 1,
            "delta.compaction.merged": 101,
            "delta.compaction.bytes": 4096, "delta.swap.versions": 1,
            "delta.served": 21, "delta.routes": 24,
            "comm.delta.scatter_bytes": 48}
    jx, pt = both(pkgs, lambda p: (p.report.render_delta_table({}),
                                   p.report.render_delta_table(ctrs)))
    assert pt == jx
    assert "delta off" in pt[0]
    for s in ("11 update batches", "101 entries merged",
              "21 two-term serves", "48"):
        assert s in pt[1]


# -------------------------------------- every renderer, both artifacts --

def _workload(p):
    """Engine, gateway (packed, inline banded, a shed storm), resilience,
    attribution, SLOs, placement and the delta layer, all armed, with
    spans on: the artifact every renderer reads."""
    for k in ("gateway", "resil", "obs_attrib", "obs_slo", "placement",
              "delta"):
        setattr(p.settings, k, True)
    p.settings.resil_backoff_ms = 0.0
    p.resil.reset()
    p.obs.enable()
    A1, A2 = p.csr(random_sp(seed=3)), p.csr(random_sp(seed=4))
    band = p.csr(tridiag_sp(256))
    from importlib import import_module

    placement = import_module(p.sparse.__name__ + ".placement")
    delta = import_module(p.sparse.__name__ + ".delta")
    placement.place("placed", band)
    D = delta.DeltaCSR(p.csr(tridiag_sp(64)))
    gw = p.gateway(max_batch=4)
    try:
        futs = []
        for s in range(3):
            futs += [gw.submit(A1, p.x(400, seed=s), tenant="alice",
                               qos="interactive"),
                     gw.submit(A2, p.x(400, seed=s + 9), tenant="bob",
                               qos="batch"),
                     gw.submit(band, p.x(256, seed=s), tenant="placed",
                               qos="interactive"),
                     gw.submit(D, p.x(64, seed=s), tenant="mut",
                               qos="background")]
            D.update([s], [s], [float(s + 2)])
        with p.resil.deadline.scope(0.0):
            futs.append(gw.submit(A1, p.x(400), tenant="late",
                                  qos="background"))
        gw.flush()
        for f in futs:
            f.result(timeout=60)
        D.compact()
        placement.migrate_to("placed", 1)
    finally:
        gw.shutdown()
        placement.reset()
    p.slo.evaluate()
    doc = p.obs.to_chrome_trace()
    return json.loads(json.dumps(doc, default=str))


_COUNTER_TABLES = ("render_plans_table", "render_resil_table",
                   "render_gateway_table", "render_tenants_table",
                   "render_placement_table", "render_delta_table")


def test_every_renderer_equal_on_both_packages_artifacts(pkgs):
    """The plan, latency, resilience, gateway, tenant, placement, delta,
    flow and SLO tables and the per-op table: for the artifact of the
    port's run and for the JAX package's run of the same workload, the
    port's renderers return the JAX renderers' text."""
    docs = both(pkgs, _workload)
    jr, tr = pkgs["jax"].report, pkgs["torch"].report
    for doc in docs:
        meta = doc["otherData"]
        ctrs, hists = meta["counters"], meta["histograms"]
        assert any(k.startswith("attrib.") for k in ctrs)
        assert any(k.startswith("placement.") for k in ctrs)
        assert any(k.startswith("delta.") for k in ctrs)
        for name in _COUNTER_TABLES:
            assert getattr(tr, name)(ctrs) == getattr(jr, name)(ctrs), name
        assert tr.render_latency_table(hists) == \
            jr.render_latency_table(hists)
        recs = [dict(r, ts_ns=r["ts"] * 1e3, type="span" if
                     r.get("ph") == "X" else "event",
                     dur_ns=r.get("dur", 0.0) * 1e3,
                     attrs=r.get("args") or {})
                for r in doc["traceEvents"] if r.get("ph") in ("X", "i")]
        assert tr.render_flows_table(recs) == jr.render_flows_table(recs)
        assert tr.render_slo_table(ctrs, recs) == \
            jr.render_slo_table(ctrs, recs)
        assert tr.aggregate(recs) == jr.aggregate(recs)
        assert tr.summarize(recs, stream_gbs=100.0) == \
            jr.summarize(recs, stream_gbs=100.0)


# ------------------------------------------------------------- regress --

def _bench(name):
    return os.path.join(REPO, name)


def test_regress_compare_r04_r05_equal(pkgs):
    """``regress.compare`` (and ``load_bench``, ``noise_band``,
    ``regressions``, ``render_findings``) on ``BENCH_r04.json`` against
    ``BENCH_r05.json``: equal findings and text in both packages, with
    the default bands and with a field filter."""
    def case(p):
        r = p.regress
        old, new = r.load_bench(_bench("BENCH_r04.json")), \
            r.load_bench(_bench("BENCH_r05.json"))
        out = []
        for kw in ({}, {"band_mult": 1.0, "floor": 0.05},
                   {"fields": ["*_ms", "value"], "allow_missing": True}):
            f = r.compare(old, new, **kw)
            out.append((f, r.regressions(f),
                        r.render_findings(f, band=r.noise_band(old, new))))
        return out

    jx, pt = both(pkgs, case)
    assert pt == jx
    assert pt[0][0], "the rounds share gated fields"


def test_regress_trajectory_equal(pkgs):
    """``render_trajectory`` over the bench rounds 2-5 (round 1 holds
    no result object: both packages raise ``ValueError`` on it): equal
    text."""
    names = [f"BENCH_r0{i}.json" for i in range(2, 6)]

    def case(p):
        with pytest.raises(ValueError, match="no bench result"):
            p.regress.load_bench(_bench("BENCH_r01.json"))
        rounds = [p.regress.load_bench(_bench(n)) for n in names]
        return p.regress.render_trajectory(rounds, names)

    jx, pt = both(pkgs, case)
    assert pt == jx
