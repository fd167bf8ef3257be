# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's per-tenant attribution ledger and capacity sensor
(``obs/attrib.py``, ``obs/capacity.py``) against the JAX package's: the
17 cases of ``tests/test_attrib.py``, one for one.

Both packages take the same inputs (scipy matrices and numpy operands
made from seeds; the port on ``device="cpu"``).  Tolerance: exact
everywhere.  The pure functions (``apportion``, ``tenant_label``,
``recommend``, the renderers, the doctor's rules) give equal values or
equal text, also on fuzzed inputs; the measured ones (span durations)
are held to the conservation identities on each side.

The multi-device cases run on 8 gloo ranks (one spawn, the rank
function in ``utils_test/torch_ops_ranks.py``, a module without JAX)
against the JAX package's 8-device mesh.  A rank's ledger holds that
rank's spans and wire bytes, and conservation holds on every rank
against its own ``comm.total_*``; the per-rank byte counts equal the JAX
package's single ledger (each rank records the dispatch's whole
predicted volume, as the JAX controller does).
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from utils_test.tools import load_tool
from utils_test.torch_ops_ranks import banded_sp, random_sp, xnp

WORLD = 8
RANK_TIMEOUT = 300.0
_KNOBS = ("gateway", "resil", "resil_retries", "resil_backoff_ms",
          "resil_breaker_k", "resil_breaker_cooldown_ms", "obs_attrib",
          "obs_tenant_cap", "obs_slo", "obs_slo_watchdog_ms", "placement",
          "placement_cooldown_ms", "placement_watchdog_ms",
          "placement_amortize", "placement_bw_gbps")


class Pkg:
    """One package's side of a case: the same calls under one name."""

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
        self.attrib, self.capacity = obs.attrib, obs.capacity
        self.slo, self.report, self.context = obs.slo, obs.report, obs.context
        self.counters, self.export = obs.counters, obs.export

    def csr(self, S):
        if self.name == "jax":
            return self.sparse.csr_array(S)
        return self.sparse.csr_array(S, device="cpu")

    def x(self, n, seed=1):
        v = xnp(n, seed)
        return jnp.asarray(v) if self.name == "jax" else torch.from_numpy(v)

    def np(self, y):
        return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)

    def gateway(self, **kw):
        base = dict(max_batch=64, queue_depth=128, tenant_quota=64,
                    rate=0.0, burst=16.0, slack_ms=1.0, timeout_ms=0.0)
        base.update(kw)
        return self.engine.Gateway(self.engine.Engine(), **base)

    def tenant_sum(self, kind):
        return sum(v for k, v in self.counters.snapshot(
            "attrib.tenant.").items() if k.endswith("." + kind))

    def span_sum(self):
        return sum(r["dur_ns"] for r in self.obs.records()
                   if r.get("type") == "span"
                   and r["name"] in self.attrib.DISPATCH_SPANS)


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
        _reset(p)
    runtime.set_device(None)


def both(pkgs, case):
    """``case(pkg)`` for the JAX package, then the port."""
    return case(pkgs["jax"]), case(pkgs["torch"])


def attrib_on(p):
    p.settings.obs_attrib = True


# ------------------------------------------------- apportioning rule --

def test_apportion_conserves_and_orders_remainder(pkgs):
    """``test_attrib.py::test_apportion_conserves_and_orders_remainder``,
    plus 300 fuzzed (total, members) pairs: equal shares in both
    packages, summing to the total."""
    members = [("b", "x"), ("a", "x"), ("a", "x")]
    for p in pkgs.values():
        ap = p.attrib.apportion
        assert ap(10, members) == [3, 4, 3]
        assert ap(9, members) == [3, 3, 3]
        assert ap(2, members) == [0, 1, 1]
        assert ap(0, members) == [0, 0, 0]
        assert ap(7, [("t", "q")]) == [7]
    rng = np.random.default_rng(0)
    for _ in range(300):
        k = int(rng.integers(1, 7))
        mem = [(str(rng.choice(["a", "b", "c", "__untagged__"])),
                str(rng.choice(["interactive", "batch", "none"])))
               for _ in range(k)]
        total = int(rng.integers(0, 10 ** 7))
        jx = pkgs["jax"].attrib.apportion(total, mem)
        assert pkgs["torch"].attrib.apportion(total, mem) == jx
        assert sum(jx) == total


# ------------------------------------------------- label sanitation --

_HOSTILE = ['evil"quote', "line\nbreak", "tab\there", "dots.in.name",
            "semi;colon", "back\\slash", "uniécode-\U0001f680", "x" * 200]


def test_tenant_label_fuzz_sanitizes_hostile_names(pkgs):
    """``::test_tenant_label_fuzz_sanitizes_hostile_names``: the hostile
    names and 50 fuzzed ones (quotes, dots, newlines, unicode) map to the
    same safe labels in both packages."""
    rng = np.random.default_rng(1)
    alphabet = list('ab."\n\\ é\U0001f680_-Z9;')
    fuzz = ["".join(rng.choice(alphabet, int(rng.integers(0, 80))))
            for _ in range(50)]

    def case(p):
        attrib_on(p)
        labels = [p.attrib.tenant_label(raw) for raw in _HOSTILE + fuzz]
        for raw, label in zip(_HOSTILE, labels):
            assert label and len(label) <= 64, raw
            assert set(label) <= p.attrib._SAFE, (raw, label)
        assert p.attrib.tenant_label("\U0001f680\U0001f680") == "t2"
        assert p.attrib.tenant_label("") == p.attrib.UNTAGGED
        assert p.attrib.tenant_label(None) == p.attrib.UNTAGGED
        assert p.attrib.tenant_label(p.attrib.OTHER) == p.attrib.OTHER
        return labels

    jx, pt = both(pkgs, case)
    assert pt == jx


def test_tenant_label_fuzz_openmetrics_roundtrip(pkgs):
    """``::test_tenant_label_fuzz_openmetrics_roundtrip``: the sanitized
    counters survive render -> parse exactly, and both packages render
    the same OpenMetrics counter family (the latency family lists every
    histogram the process ever named, which depends on the tests run
    before in it)."""
    def case(p):
        attrib_on(p)
        for raw in ('quo"te', "new\nline", "unié-\U0001f680",
                    "ok-tenant_1"):
            with p.attrib.scope([(raw, "interactive")]):
                p.attrib.on_comm("fuzz_op", 37, 1)
        snap = p.counters.snapshot("attrib.")
        assert snap
        text = p.export.snapshot_openmetrics()
        parsed, _ = p.export.parse_openmetrics(text)
        for name, val in snap.items():
            assert parsed.get(name) == val, name
        return [ln for ln in text.splitlines() if "_counter" in ln]

    jx, pt = both(pkgs, case)
    assert pt == jx


def test_tenant_cap_folds_overflow_into_other(pkgs):
    """``::test_tenant_cap_folds_overflow_into_other``."""
    def case(p):
        attrib_on(p)
        p.settings.obs_tenant_cap = 2
        labels = [p.attrib.tenant_label(t) for t in
                  ("alpha", "beta", "gamma", "delta", "alpha")]
        folds = p.counters.get("attrib.fold.other")
        with p.attrib.scope([("gamma", "batch")]):
            p.attrib.on_comm("cap_op", 11, 1)
        return labels, folds, p.counters.snapshot("attrib.")

    jx, pt = both(pkgs, case)
    assert pt == jx
    assert pt[0] == ["alpha", "beta", "__other__", "__other__", "alpha"]
    assert pt[1] == 2
    assert pt[2]["attrib.tenant.__other__.comm_bytes"] == 11


# ----------------------------------------- conservation: wall time --

def _packed_gateway(p):
    attrib_on(p)
    p.settings.gateway = True
    p.obs.enable()
    A1, A2 = p.csr(random_sp(seed=3)), p.csr(random_sp(seed=4))
    gw = p.gateway(max_batch=4)
    try:
        futs = [gw.submit(A, p.x(400, seed=s), tenant=t, qos=q)
                for A, s, t, q in ((A1, 1, "alice", "interactive"),
                                   (A2, 2, "alice", "interactive"),
                                   (A1, 3, "bob", "batch"),
                                   (A2, 4, "bob", "batch"))]
        gw.flush()
        ys = [p.np(f.result(timeout=60)) for f in futs]
    finally:
        gw.shutdown()
    span_sum = p.span_sum()
    assert span_sum > 0
    assert p.tenant_sum("wall_ns") == \
        p.counters.get("attrib.total.wall_ns") == span_sum
    for tenant in ("alice", "bob"):
        assert p.counters.get(f"attrib.tenant.{tenant}.wall_ns") > 0
        assert p.counters.get(f"attrib.tenant.{tenant}.wait_ns") > 0
    assert sum(p.counters.snapshot("attrib.op.").values()) == span_sum
    assert p.counters.get("util.busy_ns") == span_sum
    return (p.tenant_sum("dispatches"), p.counters.get("util.dispatches"),
            sorted(p.counters.snapshot("attrib.").keys()), ys)


def test_packed_gateway_wall_ns_conserves_to_span_sum(pkgs):
    """``::test_packed_gateway_wall_ns_conserves_to_span_sum``: per-tenant
    wall ns sums exactly to the dispatch spans' durations in each
    package; the dispatch counts and counter families equal, the results
    bit for bit."""
    jx, pt = both(pkgs, _packed_gateway)
    assert pt[0] == jx[0] == 4
    assert pt[1] == jx[1] >= 1
    assert pt[2] == jx[2]
    for a, b in zip(pt[3], jx[3]):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------- capacity layer --

_WEIGHTS = {"interactive": 8.0, "batch": 4.0, "background": 1.0}


def test_recommend_is_pure_and_deterministic(pkgs):
    """``::test_recommend_is_pure_and_deterministic``, plus 200 fuzzed
    (demand, burns, devices) inputs: equal recommendations."""
    demand = {"a": {"busy_ns": 6_000_000_000, "qos": "interactive"},
              "b": {"busy_ns": 3_000_000_000, "qos": "batch"},
              "c": {"busy_ns": 1_000_000_000, "qos": "background"}}
    for p in pkgs.values():
        rec = p.capacity.recommend(demand, _WEIGHTS, {}, devices=8)
        assert [rec["tenants"][t]["devices"] for t in "abc"] == [6, 1, 1]
        assert rec["allocated"] == 8 and rec["undersized"] is False
        rec2 = p.capacity.recommend(
            demand, _WEIGHTS, {"interactive": p.capacity.BURN_PAGE}, 8)
        assert rec2["tenants"]["a"]["devices"] == 7
        assert rec2["allocated"] == 9 and rec2["undersized"] is True
        assert p.capacity.recommend({}, _WEIGHTS, {}, 8)["allocated"] == 0
    rng = np.random.default_rng(2)
    qos = list(_WEIGHTS) + [None, "other"]
    for _ in range(200):
        dem = {f"t{i}": {"busy_ns": int(rng.integers(0, 10 ** 10)),
                         "qos": qos[int(rng.integers(len(qos)))]}
               for i in range(int(rng.integers(0, 7)))}
        burns = {q: float(rng.choice([0.0, 1.0, 14.4, 100.0]))
                 for q in _WEIGHTS}
        devices = int(rng.integers(1, 17))
        assert pkgs["torch"].capacity.recommend(
            dem, _WEIGHTS, burns, devices) == pkgs["jax"].capacity.recommend(
            dem, _WEIGHTS, burns, devices)


def test_utilization_window_evicts_by_timestamp(pkgs):
    """``::test_utilization_window_evicts_by_timestamp``."""
    def case(p):
        attrib_on(p)
        p.capacity.note_busy(5_000_000, (("alice", "interactive"),))
        p.capacity.note_busy(3_000_000, (("bob", "batch"),))
        now = time.monotonic_ns()
        util = p.capacity.utilization(60_000.0, now_ns=now)
        empty = p.capacity.utilization(1.0, now_ns=now + 10 ** 12)
        return (util, empty, p.counters.get("util.busy_ns"),
                p.counters.get("util.dispatches"))

    jx, pt = both(pkgs, case)
    assert pt == jx
    assert pt[0]["per_tenant"] == {"alice": 5_000_000, "bob": 3_000_000}
    assert pt[1]["busy_ns"] == 0 and pt[1]["per_tenant"] == {}
    assert pt[2:] == (8_000_000, 2)


def test_capacity_report_emits_recommendation_event(pkgs):
    """``::test_capacity_report_emits_recommendation_event``: equal
    recommendation and event attributes."""
    def case(p):
        attrib_on(p)
        p.obs.enable()
        with p.attrib.scope([("alice", "interactive")]):
            p.attrib.on_span_close("gateway.batch", 5_000_000, True)
        rec = p.capacity.capacity_report(devices=8)
        evs = [r for r in p.obs.records()
               if r["name"] == "capacity.recommendation"]
        assert len(evs) == 1 and p.counters.get("capacity.reports") == 1
        attrs = dict(evs[0]["attrs"])
        attrs.pop("trace_id", None)
        return rec, attrs

    jx, pt = both(pkgs, case)
    assert pt == jx
    rec, at = pt
    assert rec["tenants"]["alice"]["devices"] == 8
    assert at["devices"] == 8 and at["allocated"] == 8


# ------------------------------------------------------- surfaces --

_TENANT_CTRS = {"attrib.tenant.alice.comm_bytes": 86,
                "attrib.tenant.alice.wall_ns": 2_000_000,
                "attrib.tenant.bob.comm_bytes": 42,
                "attrib.total.comm_bytes": 128,
                "comm.total_bytes": 128,
                "util.busy_ns": 2_000_000,
                "util.dispatches": 1}


def test_render_tenants_table_conservation_line(pkgs):
    """``::test_render_tenants_table_conservation_line``: the same text
    in both packages, for the JAX test's counters and a violated
    ledger."""
    bad = dict(_TENANT_CTRS, **{"attrib.total.comm_bytes": 999})
    for ctrs in ({}, _TENANT_CTRS, bad):
        jx, pt = both(pkgs, lambda p: p.report.render_tenants_table(ctrs))
        assert pt == jx
    out = pkgs["torch"].report.render_tenants_table(_TENANT_CTRS)
    assert "conservation: 128 attributed bytes" in out
    assert "exact" in out and "utilization:" in out
    assert "VIOLATED" in pkgs["torch"].report.render_tenants_table(bad)


def test_trace_summary_tenants_flag(pkgs, tmp_path):
    """``::test_trace_summary_tenants_flag``, its report half: the
    tenants table rendered from a written Chrome trace's counters is the
    JAX renderer's text for the same counters (the ``trace_summary``
    CLI itself is the JAX package's tool)."""
    import json

    def case(p):
        attrib_on(p)
        p.obs.enable()
        with p.attrib.scope([("alice", "interactive"), ("bob", "batch")]):
            p.attrib.on_comm("unit_op", 9, 1)
            with p.obs.span("engine.batch"):
                pass
        path = tmp_path / f"{p.name}.trace.json"
        p.obs.write_chrome_trace(str(path))
        return json.loads(path.read_text())["otherData"]["counters"]

    _, ctrs = both(pkgs, case)
    out = pkgs["torch"].report.render_tenants_table(ctrs)
    assert out == pkgs["jax"].report.render_tenants_table(ctrs)
    assert "alice" in out and "bob" in out
    assert "conservation:" in out and "exact" in out


def test_doctor_noisy_neighbor_rule(pkgs):
    """``::test_doctor_noisy_neighbor_rule``: the port's doctor gives
    ``tools/doctor.py``'s findings on every evidence of the JAX test."""
    from legate_sparse_tpu_torch.obs import doctor

    jdoctor = load_tool("doctor")
    cases = [
        {"attrib.tenant.hog.wall_ns": 9e9,
         "attrib.tenant.meek.wall_ns": 1e9,
         "slo.breach.gateway.interactive": 2},
        {"attrib.tenant.hog.wall_ns": 9e9,
         "attrib.tenant.meek.wall_ns": 1e9},
        {"attrib.tenant.a.wall_ns": 5e9, "attrib.tenant.b.wall_ns": 5e9,
         "slo.breach.gateway.interactive": 1},
        {"attrib.tenant.hog.wall_ns": 9e9,
         "attrib.tenant.__untagged__.wall_ns": 1e9,
         "slo.breach.gateway.interactive": 1},
    ]
    got = []
    for ctrs in cases:
        ev, jev = doctor.Evidence(), jdoctor.Evidence()
        ev.counters, jev.counters = dict(ctrs), dict(ctrs)
        findings = doctor.diagnose(ev)
        assert findings == jdoctor.diagnose(jev)
        got.append([f["code"] for f in findings])
    assert "noisy-neighbor" in got[0]
    hog = next(f for f in doctor.diagnose(_evidence(doctor, cases[0]))
               if f["code"] == "noisy-neighbor")
    assert "hog" in hog["message"] and hog["value"] == "0.90"
    assert all("noisy-neighbor" not in g for g in got[1:])


def _evidence(doctor, ctrs):
    ev = doctor.Evidence()
    ev.counters = dict(ctrs)
    return ev


def test_graph_slos_registered_by_default(pkgs):
    """``::test_graph_slos_registered_by_default``: the same registry."""
    def case(p):
        return [tuple(vars(s).values()) for s in p.slo.registered()]

    jx, pt = both(pkgs, case)
    assert pt == jx
    byname = {s.name: s for s in pkgs["torch"].slo.registered()}
    for alg, objective in (("bfs", 1000.0), ("sssp", 2000.0),
                           ("cc", 2000.0), ("pagerank", 5000.0)):
        s = byname[f"graph.{alg}"]
        assert s.hist_prefix == f"lat.graph.{alg}"
        assert s.objective_ms == objective and s.target == 0.95


def test_trace_context_carries_tenant_and_qos(pkgs):
    """``::test_trace_context_carries_tenant_and_qos``."""
    def case(p):
        c = p.context.mint(rid=1, tenant="alice", qos="interactive")
        assert "alice" in repr(c)
        with p.context.use(c):
            assert p.context.mint(rid=2, tenant="bob", qos="batch") is c
            members = p.attrib.current_members()
        return (c.tenant, c.qos, members,
                p.context.mint(rid=3).tenant)

    jx, pt = both(pkgs, case)
    assert pt == jx == ("alice", "interactive",
                        (("alice", "interactive"),), None)


# ------------------------------------- the operations settings off --

def _serving_load(p):
    """Phase 16's gateway load in small: three tenants over two stages
    (a packed engine batch, then inline banded and block tenants)."""
    p.settings.gateway = True
    A1, A2 = p.csr(random_sp(seed=3)), p.csr(random_sp(seed=4))
    band = p.csr(banded_sp(256))
    gw = p.gateway(max_batch=8)
    ys = []
    try:
        for stage in range(2):
            futs = [gw.submit(A, p.x(A.shape[0], seed=10 * stage + i),
                              tenant=t, qos=q)
                    for i, (A, t, q) in enumerate((
                        (A1, "alpha", "interactive"), (A2, "beta", "batch"),
                        (A1, "gamma", "background"),
                        (band, "band", "interactive")))]
            gw.flush()
            ys += [p.np(f.result(timeout=60)) for f in futs]
    finally:
        gw.shutdown()
    return ys


_NEW_FAMILIES = ("attrib.", "util.", "capacity.", "slo.", "placement.")


def test_ops_settings_off_leave_serving_counters_unchanged(pkgs):
    """With the nine operations settings off (their defaults), the
    serving load moves no ``attrib.``/``util.``/``capacity.``/``slo.``/
    ``placement.`` counter, its ``gateway.*`` counters equal the JAX
    package's, and turning attribution and SLOs on changes no result
    and no count of the load's own counters (host-clock sums aside)."""
    t = pkgs["torch"]
    for p in pkgs.values():
        for k in ("obs_attrib", "obs_slo", "placement"):
            assert getattr(p.settings, k) is False, k
    ys_off = _serving_load(t)
    off = t.counters.snapshot("")
    assert not [k for k in off if k.startswith(_NEW_FAMILIES)]
    jys = _serving_load(pkgs["jax"])
    assert t.counters.snapshot("gateway.") == \
        pkgs["jax"].counters.snapshot("gateway.")
    for a, b in zip(ys_off, jys):
        np.testing.assert_array_equal(a, b)
    _reset(t)
    t.settings.obs_attrib = t.settings.obs_slo = True
    t.obs.enable()
    ys_on = _serving_load(t)
    t.export.snapshot_openmetrics()
    on = t.counters.snapshot("")
    # Same counters and, but for the host-clock ones, the same values.
    assert set(off) <= set(on)
    clock = ("_ms", "_ns")
    assert {k: on[k] for k in off if not k.endswith(clock)} == \
        {k: v for k, v in off.items() if not k.endswith(clock)}
    assert any(k.startswith("attrib.") for k in on)
    for a, b in zip(ys_off, ys_on):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- the 8-rank cases --

@pytest.fixture(scope="module")
def jax_mesh_cases():
    """The JAX package's side of the multi-device cases, on its 8-device
    mesh (run before the ranks spawn)."""
    import legate_sparse_tpu as jsparse
    from legate_sparse_tpu import obs, resilience
    from legate_sparse_tpu.obs import attrib, context, counters
    from legate_sparse_tpu.parallel import make_row_mesh, shard_csr
    from legate_sparse_tpu.parallel.dist_csr import dist_spmv, shard_vector
    from legate_sparse_tpu.settings import settings

    if len(jax.devices()) < WORLD:
        pytest.skip("needs 8 virtual devices")
    p = Pkg("jax")
    saved = {k: getattr(settings, k) for k in _KNOBS}
    out = {}
    try:
        _reset(p)
        settings.obs_attrib = True
        mesh = make_row_mesh(jax.devices()[:WORLD])
        n = 32 * WORLD
        dA = shard_csr(jsparse.csr_array(banded_sp(n)), mesh=mesh)
        x = shard_vector(np.ones(n, np.float32), mesh, dA.rows_padded)
        with context.use(context.mint(tenant="alice", qos="interactive")):
            np.asarray(dist_spmv(dA, x))
        with attrib.scope([("alice", "interactive"), ("bob", "batch"),
                           ("carol", "background")]):
            np.asarray(dist_spmv(dA, x))
        out["bytes"] = {"attrib": counters.snapshot("attrib."),
                        "comm_total_bytes": counters.get("comm.total_bytes"),
                        "comm_total_calls": counters.get("comm.total_calls")}
        _reset(p)
        settings.gateway = settings.resil = True
        settings.resil_backoff_ms = 0.0
        resilience.reset()
        obs.enable()
        gw = p.gateway(max_batch=8)
        try:
            rep = resilience.chaos.run_drill(
                gw, tenants=[
                    {"name": "good", "qos": "interactive",
                     "A": p.csr(random_sp(seed=3)),
                     "xs": [p.x(400, seed=s) for s in range(3)]},
                    {"name": "storm", "qos": "background",
                     "A": p.csr(random_sp(seed=4)),
                     "xs": [p.x(400, seed=s) for s in range(10, 13)],
                     "deadline_ms": 0.0}],
                rounds=3, seed=7)
        finally:
            gw.shutdown()
        out["chaos"] = {"ok": rep.ok(),
                        "storm_shed": rep.per_tenant["storm"]["shed"]}
        settings.obs_attrib = False
        with attrib.scope([("alice", "interactive")]):
            out["members_off"] = attrib.current_members()
        out["report_off"] = p.capacity.capacity_report()
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        _reset(p)
    return out


@pytest.fixture(scope="module")
def attrib_ranks(jax_mesh_cases):
    from legate_sparse_tpu_torch.parallel.launch import run_ranks
    from utils_test.torch_ops_ranks import attrib_rank

    return run_ranks(attrib_rank, WORLD, backend="gloo",
                     timeout=RANK_TIMEOUT, threads=1)


def test_dist_spmv_bytes_conserve_exactly(attrib_ranks, jax_mesh_cases):
    """``::test_dist_spmv_bytes_conserve_exactly`` at 8 ranks: on every
    rank the per-tenant bytes (remainder to the first-sorted member) sum
    exactly to ``comm.total_bytes``, and equal the JAX ledger's."""
    j = jax_mesh_cases["bytes"]
    per_call = 2 * WORLD * 1 * 4
    base = per_call // 3
    for r in attrib_ranks:
        b = r["bytes"]
        assert b["halo"] == 1
        assert b["attrib"] == j["attrib"]
        assert b["attrib"]["attrib.tenant.alice.comm_bytes"] == \
            per_call + base + 1
        assert b["tenant_bytes"] == \
            b["attrib"]["attrib.total.comm_bytes"] == \
            b["comm_total_bytes"] == j["comm_total_bytes"] == 2 * per_call
        assert b["tenant_calls"] == b["comm_total_calls"] == 2


def test_chaos_drill_conserves_attribution(attrib_ranks, jax_mesh_cases):
    """``::test_chaos_drill_conserves_attribution`` at 8 ranks: the drill
    with a deadline-storm tenant plus a ``dist_spmv`` in the same window;
    bytes and wall ns conserve exactly on every rank, the shed tenant
    attributes wait and nothing else."""
    assert jax_mesh_cases["chaos"] == {"ok": True, "storm_shed": 9}
    for r in attrib_ranks:
        c = r["chaos"]
        assert c["ok"], c["violations"]
        assert c["storm_shed"] == 9
        assert c["comm_total_bytes"] > 0
        assert c["tenant_bytes"] == c["total_bytes"] == c["comm_total_bytes"]
        assert c["span_sum"] > 0
        assert c["tenant_wall"] == c["total_wall"] == c["span_sum"]
        assert c["storm"]["wait_ns"] > 0
        assert (c["storm"]["wall_ns"], c["storm"]["dispatches"],
                c["storm"]["comm_bytes"]) == (0, 0, 0)
        assert c["good_wall"] > 0


def test_attrib_inert_without_flag(attrib_ranks, jax_mesh_cases):
    """``::test_attrib_inert_without_flag`` at 8 ranks: off, tagged
    traffic moves no ``attrib.``/``util.``/``capacity.`` counter and
    the capacity report is None; on, the results are the same bits."""
    for r in attrib_ranks:
        i = r["inert"]
        assert i["members_off"] == jax_mesh_cases["members_off"] == \
            (("__untagged__", "none"),)
        assert i["inert"] == {"attrib.": {}, "util.": {}, "capacity.": {}}
        assert i["report_off"] is None is jax_mesh_cases["report_off"]
        assert i["same"] and i["attrib_on"]


def test_graph_algorithms_record_latency_histograms(attrib_ranks):
    """``::test_graph_algorithms_record_latency_histograms``: the graph
    algorithms (a collective of the job in the port) feed the always-on
    ``lat.graph.<alg>`` histograms on every rank."""
    for r in attrib_ranks:
        assert all(r["graph"][alg] >= 1
                   for alg in ("bfs", "sssp", "cc", "pagerank")), r["graph"]


def test_dist_profiler_scope_names_trace_id(attrib_ranks):
    """``dist_spmv``, ``dist_gmres`` and ``dist_cg`` open
    ``obs.context.profiler_scope`` (the JAX package's ``dist_csr.py:1460``,
    ``:1633``, ``:2266``, ``:2572``): under
    an active trace context a ``torch.profiler`` capture names them
    ``<op>[<trace-id>]``; without one it adds no such row."""
    for r in attrib_ranks:
        tid = r["profiler"]["trace_id"]
        assert r["profiler"]["names"] == sorted(
            [f"dist_cg[{tid}]", f"dist_gmres[{tid}]", f"dist_spmv[{tid}]"])
