# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's chaos drill (``resilience/chaos.py``) and the delta
layer's ``delta.compact`` site against the JAX package's: the gateway
drills of ``tests/test_gateway.py:469-551`` and the delta drills of
``tests/test_delta.py:366-449`` and ``:564-613``.

Both packages run each drill with the same scipy matrices and numpy
operands (the port on ``device="cpu"``); ``faults.inject`` is wrapped
on both sides to record the seeded schedule, which must be the same
site by site (``random.Random`` draws in one order in both).  The
device-loss drill runs on 8 gloo ranks (one spawn; this module imports
no JAX at its top), every rank with its own gateway and the same seed;
in each round the rank drawn as lost leaves the recovery solve with
``DeviceLost``, which its report counts as ``lost``, and the survivors
are held to the recovery accounting and scipy's solution inside the
drill.  The JAX package runs it on its 8-device mesh.

Held: ``report.ok()`` on both, the per-tenant ledgers, equal between
the packages where the engine serves the same requests; the compacted
base bit for bit the cold rebuild; no fault left armed.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

WORLD = 8
RANK_TIMEOUT = 240.0
_KNOBS = ("gateway", "resil", "resil_retries", "resil_backoff_ms",
          "resil_breaker_k", "resil_breaker_cooldown_ms", "delta")


def random_sp(n=400, density=0.03, seed=0):
    return sp.random(n, n, density=density, format="csr",
                     random_state=np.random.default_rng(seed),
                     dtype=np.float32)


def tridiag(n, dtype=np.float32):
    return sp.diags([np.full(n, 4.0, dtype), np.full(n - 1, -1.0, dtype),
                     np.full(n - 1, -1.0, dtype)], [0, 1, -1], format="csr",
                    dtype=dtype)


def xnp(n, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


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
        self.delta = __import__(sparse.__name__ + ".delta",
                                fromlist=["DeltaCSR"])

    def csr(self, S):
        if self.name == "jax":
            return self.sparse.csr_array(S)
        return self.sparse.csr_array(S, device="cpu")

    def x(self, n, seed=1, dtype=np.float32):
        v = xnp(n, seed, dtype)
        if self.name == "jax":
            import jax.numpy as jnp

            return jnp.asarray(v)
        return torch.from_numpy(v)

    def gateway(self, **kw):
        base = dict(max_batch=64, queue_depth=128, tenant_quota=64,
                    rate=0.0, burst=16.0, slack_ms=1.0, timeout_ms=0.0)
        base.update(kw)
        return self.engine.Gateway(self.engine.Engine(), **base)

    def np(self, x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def recording(monkeypatch, p):
    """Wrap the package's ``faults.inject`` to record every arming."""
    seen = []
    real = p.resil.faults.inject

    def inject(site, kind="error", count=1, **kw):
        seen.append((site, kind, int(count), int(kw.get("after", 0)),
                     int(kw.get("device", 0))))
        return real(site, kind=kind, count=count, **kw)

    monkeypatch.setattr(p.resil.faults, "inject", inject)
    return seen


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    from legate_sparse_tpu_torch import runtime

    runtime.set_device("cpu")
    p = Pkg(request.param)
    saved = {k: getattr(p.settings, k) for k in _KNOBS}
    p.obs.reset_all()
    p.resil.reset()
    yield p
    for k, v in saved.items():
        setattr(p.settings, k, v)
    p.resil.reset()
    p.engine.reset_engine()
    p.engine.reset_gateway()
    runtime.set_device(None)


def arm(p, delta=False):
    p.settings.gateway = True
    p.settings.resil = True
    p.settings.resil_backoff_ms = 0.0
    p.settings.delta = delta
    p.resil.reset()


_SEEN = {}


def _hold_schedule(key, p, schedule):
    got = _SEEN.setdefault(key, {})
    got[p.name] = schedule
    if len(got) == 2:
        assert got["torch"] == got["jax"]


# ------------------------------------------------------------- the drills --

def test_chaos_drill_requires_armed_system(pkg):
    with pytest.raises(RuntimeError, match="needs settings.gateway"):
        pkg.resil.chaos.run_drill(None, tenants=[])


def test_chaos_drill_isolation_invariants(pkg, monkeypatch):
    """Randomised faults from the catalog plus a deadline-storm tenant
    under live load: exactly-once resolution, exact accounting, bitwise
    parity, and the good tenant untouched; the schedule at seed 7 the
    JAX package's."""
    arm(pkg)
    seen = recording(monkeypatch, pkg)
    A_good, A_storm = pkg.csr(random_sp(seed=3)), pkg.csr(random_sp(seed=4))
    xs_good = [pkg.x(400, seed=s) for s in range(3)]
    xs_storm = [pkg.x(400, seed=s) for s in range(10, 13)]
    gw = pkg.gateway(max_batch=8)
    try:
        report = pkg.resil.chaos.run_drill(
            gw, tenants=[
                {"name": "good", "qos": "interactive", "A": A_good,
                 "xs": xs_good},
                {"name": "storm", "qos": "background", "A": A_storm,
                 "xs": xs_storm, "deadline_ms": 0.0}],
            rounds=4, seed=7)
    finally:
        gw.shutdown()
    assert report.ok(), report.violations
    assert report.submitted == 24
    assert report.served + report.shed + report.errors == 24
    assert report.faults_armed == len(seen) >= 4
    good = report.per_tenant["good"]
    assert good == {"submitted": 12, "served": 12, "shed": 0, "error": 0}
    storm = report.per_tenant["storm"]
    assert storm["submitted"] == 12 and storm["shed"] >= 1
    assert not pkg.resil.faults.armed()
    assert pkg.resil.policy.breaker("gateway.dispatch").state == "closed"
    _hold_schedule(7, pkg, seen)
    _hold_schedule(("ledger", 7), pkg, report.per_tenant)


@pytest.mark.parametrize("seed", [7, 11])
def test_schedule_draws_equal_jax(pkg, monkeypatch, seed):
    """The drill's seeded schedule, site by site, with no tenant load:
    the two packages' ``random.Random`` draws arm the same faults."""
    arm(pkg)
    seen = recording(monkeypatch, pkg)
    gw = pkg.gateway()
    try:
        report = pkg.resil.chaos.run_drill(gw, tenants=[], rounds=6,
                                           seed=seed)
    finally:
        gw.shutdown()
    assert report.ok() and report.faults_armed == len(seen)
    _hold_schedule(("bare", seed), pkg, seen)


def test_chaos_migration_needs_placement(pkg):
    """``migration=`` needs the placement layer: a typed RuntimeError
    (the port has no ``placement/`` yet; the JAX package raises the same
    type while ``settings.placement`` is off)."""
    arm(pkg)
    with pytest.raises(RuntimeError, match="placement"):
        pkg.resil.chaos.run_drill(None, tenants=[],
                                  migration={"tenant": "t",
                                             "devices": (2, 4)})


# ------------------------------------------------------------ delta drills --

def _cold(S, targets):
    S = sp.coo_matrix(S)
    merged = {(int(r), int(c)): v for r, c, v in zip(S.row, S.col, S.data)}
    for key, v in targets.items():
        if v == 0.0:
            merged.pop(key, None)
        else:
            merged[key] = v
    keys = sorted(merged)
    return sp.csr_matrix((np.asarray([merged[k] for k in keys], S.dtype),
                          ([k[0] for k in keys], [k[1] for k in keys])),
                         shape=S.shape)


def test_compact_snapshots_buffer_under_checkpoint_scope(pkg):
    arm(pkg, delta=True)
    D = pkg.delta.DeltaCSR(pkg.csr(tridiag(32, np.float64)))
    D.update([3, 5], [2, 5], [1.5, 0.0])
    with pkg.resil.checkpoint.scope("delta.compact", every=1) as ck:
        assert D.compact() == 2
    assert ck.saves == 1
    assert ck.iterations == 0, "keyed by the pre-swap version"
    rows, cols, vals = ck.arrays
    np.testing.assert_array_equal(rows, [3, 5])
    np.testing.assert_array_equal(cols, [2, 5])
    np.testing.assert_array_equal(vals, [1.5, 0.0])
    assert vals.dtype == np.float64 and rows.dtype == np.int64


def test_compact_retries_injected_fault_exactly_once(pkg):
    """An injected error at ``delta.compact`` is retried; the swap lands
    once and the merged base is the cold rebuild bit for bit."""
    arm(pkg, delta=True)
    S = tridiag(32, np.float64)
    D = pkg.delta.DeltaCSR(pkg.csr(S))
    D.update([0], [2], [42.0])
    pkg.resil.faults.inject("delta.compact", kind="error", count=1)
    try:
        assert D.compact() == 1
    finally:
        pkg.resil.faults.clear()
    c = pkg.obs.counters.snapshot("")
    assert c.get("resil.retry.delta.compact") == 1
    assert c.get("delta.compactions") == 1
    assert c.get("delta.swap.versions") == 1
    assert D.version == 1 and D.pending == 0
    ref = _cold(S, {(0, 2): 42.0})
    np.testing.assert_array_equal(pkg.np(D.base.data), ref.data)
    np.testing.assert_array_equal(pkg.np(D.base.indices), ref.indices)


def test_compact_exhausted_retries_keep_buffer_intact(pkg):
    """A compaction failing past the retry budget propagates and leaves
    the buffer and the version as they were."""
    arm(pkg, delta=True)
    D = pkg.delta.DeltaCSR(pkg.csr(tridiag(32, np.float64)))
    D.update([1], [1], [9.0])
    pkg.resil.faults.inject("delta.compact", kind="error", count=99)
    try:
        with pytest.raises(Exception):
            D.compact()
    finally:
        pkg.resil.faults.clear()
    assert D.pending == 1 and D.version == 0
    assert D.entries() == {(1, 1): 9.0}
    assert pkg.obs.counters.snapshot("delta.").get("delta.compactions",
                                                    0) == 0


def test_chaos_mutation_scenario_requires_delta(pkg):
    arm(pkg, delta=False)
    with pytest.raises(RuntimeError, match="settings.delta"):
        pkg.resil.chaos.run_drill(None, tenants=[],
                                  mutation={"tenant": "t"})


def test_chaos_drill_mutation_mid_storm(pkg, monkeypatch):
    """100 seeded updates stream into a served tenant under live load
    with composed faults; one compaction mid-round with an atomic swap:
    exact ``delta.*`` accounting, bitwise parity on whichever version
    served, the compacted base the cold rebuild (held in the drill);
    the schedule at seed 3 the JAX package's."""
    arm(pkg, delta=True)
    seen = recording(monkeypatch, pkg)
    gw = pkg.gateway(max_batch=8, burst=64.0)
    c0 = pkg.obs.counters.snapshot("")
    try:
        report = pkg.resil.chaos.run_drill(
            gw, tenants=[
                {"name": "mut", "qos": "interactive",
                 "A": pkg.csr(tridiag(128, np.float64)),
                 "xs": [pkg.x(128, seed=s, dtype=np.float64)
                        for s in range(3)]},
                {"name": "storm", "qos": "background",
                 "A": pkg.csr(tridiag(96, np.float64)),
                 "xs": [pkg.x(96, seed=s, dtype=np.float64)
                        for s in range(10, 13)],
                 "deadline_ms": 0.0}],
            rounds=4, seed=3,
            mutation={"tenant": "mut", "updates": 100, "seed": 11})
    finally:
        gw.shutdown()
    c1 = pkg.obs.counters.snapshot("")

    def moved(name):
        return int(c1.get(name, 0)) - int(c0.get(name, 0))

    assert report.ok(), report.violations
    assert report.mutations == 10 and report.compactions == 1
    assert moved("delta.compactions") == 1
    assert moved("delta.swap.versions") == 1
    assert moved("delta.updates") == 10
    assert not pkg.resil.faults.armed()
    _hold_schedule(3, pkg, seen)
    _hold_schedule(("mutation-counts", 3), pkg,
                   {k: moved(k) for k in ("delta.applied",
                                          "delta.overwrites",
                                          "delta.compaction.merged")})


# ------------------------------------------------- the device-loss drill --

def _loss_drill(rank, world):
    from legate_sparse_tpu_torch import engine, parallel as P, resilience
    from legate_sparse_tpu_torch import runtime
    from legate_sparse_tpu_torch.settings import settings

    runtime.set_device("cpu")
    p = Pkg("torch")
    arm(p)
    seen = []
    real = resilience.faults.inject

    def inject(site, kind="error", count=1, **kw):
        seen.append((site, kind, int(count), int(kw.get("after", 0)),
                     int(kw.get("device", 0))))
        return real(site, kind=kind, count=count, **kw)

    resilience.faults.inject = inject
    dA = P.shard_csr(p.csr(tridiag(256)))
    A_good = p.csr(random_sp(seed=3))
    xs_good = [p.x(400, seed=s) for s in range(3)]
    gw = p.gateway(max_batch=8)
    try:
        report = resilience.chaos.run_drill(
            gw, tenants=[{"name": "good", "qos": "interactive",
                          "A": A_good, "xs": xs_good}],
            rounds=2, seed=11,
            device_loss={"A": dA, "b": np.ones(256, np.float32),
                         "rtol": 1e-8, "conv_test_iters": 5,
                         "ckpt_iters": 10})
    finally:
        gw.shutdown()
        resilience.faults.inject = real
        engine.reset_gateway()
    settings.gateway = settings.resil = False
    return {"ok": report.ok(), "violations": report.violations,
            "recoveries": report.recoveries, "lost": report.lost,
            "per_tenant": report.per_tenant, "schedule": seen,
            "armed": resilience.faults.armed()}


@pytest.fixture(scope="module")
def loss_port(loss_jax):
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_loss_drill, WORLD, backend="gloo",
                     timeout=RANK_TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def loss_jax():
    import jax
    import jax.numpy as jnp

    import legate_sparse_tpu as jsparse
    from legate_sparse_tpu import engine, resilience
    from legate_sparse_tpu.parallel import make_row_mesh, shard_csr
    from legate_sparse_tpu.settings import settings

    if len(jax.devices("cpu")) < WORLD:
        pytest.skip("needs 8 virtual devices")
    saved = {k: getattr(settings, k) for k in _KNOBS}
    seen = []
    real = resilience.faults.inject

    def inject(site, kind="error", count=1, **kw):
        seen.append((site, kind, int(count), int(kw.get("after", 0)),
                     int(kw.get("device", 0))))
        return real(site, kind=kind, count=count, **kw)

    resilience.faults.inject = inject
    try:
        settings.gateway = settings.resil = True
        settings.resil_backoff_ms = 0.0
        resilience.reset()
        dA = shard_csr(jsparse.csr_array(tridiag(256)),
                       mesh=make_row_mesh(jax.devices("cpu")[:WORLD]))
        gw = engine.Gateway(engine.Engine(), max_batch=8, queue_depth=128,
                            tenant_quota=64, rate=0.0, burst=16.0,
                            slack_ms=1.0, timeout_ms=0.0)
        try:
            report = resilience.chaos.run_drill(
                gw, tenants=[{"name": "good", "qos": "interactive",
                              "A": jsparse.csr_array(random_sp(seed=3)),
                              "xs": [jnp.asarray(xnp(400, s))
                                     for s in range(3)]}],
                rounds=2, seed=11,
                device_loss={"A": dA, "b": np.ones(256, np.float32),
                             "rtol": 1e-8, "conv_test_iters": 5,
                             "ckpt_iters": 10})
        finally:
            gw.shutdown()
    finally:
        resilience.faults.inject = real
        for k, v in saved.items():
            setattr(settings, k, v)
        resilience.reset()
        engine.reset_gateway()
    return {"report": report, "schedule": seen}


def test_chaos_drill_device_loss_recovery_under_load(loss_port, loss_jax):
    """Each round one rank is lost and the rest recover; the reports
    hold, the live load rides through, nothing stays armed."""
    j = loss_jax["report"]
    assert j.ok(), j.violations
    assert j.recoveries == 2
    for r in loss_port:
        assert r["ok"], r["violations"]
        assert r["recoveries"] + r["lost"] == 2
        assert r["per_tenant"]["good"] == {
            "submitted": 6, "served": 6, "shed": 0, "error": 0}
        assert r["per_tenant"] == j.per_tenant
        assert not r["armed"]
    assert sum(r["lost"] for r in loss_port) == 2


def test_device_loss_drill_schedule_equals_jax(loss_port, loss_jax):
    """Seed 11's schedule, the drawn lost ordinals among it, the same on
    every rank and in the JAX package, site by site; the ranks that
    were lost are the drawn ordinals."""
    sched = loss_jax["schedule"]
    assert all(r["schedule"] == sched for r in loss_port)
    drawn = [s[4] for s in sched if s[1] == "device_loss"]
    assert len(drawn) == 2
    lost = sorted(i for i, r in enumerate(loss_port) for _ in range(r["lost"]))
    assert lost == sorted(drawn)
