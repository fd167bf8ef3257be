# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The request half of the port's resilience layer
(``legate_sparse_tpu_torch/resilience``: faults, policy, deadline,
outcomes) and its sites on the serving path (``engine.*``, ``csr.dot``)
against the JAX package's on the CPU.

Mirrors the request-path cases of ``tests/test_resilience.py``; its
solver, health, checkpoint and distributed cases wait for the solver and
distribution half of the layer.  A drill is written once against an
adapter and run on both packages with the same scipy matrices and numpy
operands, made from a seed; the port runs on ``device="cpu"``.

Held equal between the packages: the ``resil.*`` counters a drill moves
and its outcomes.  A recovered product is bit for bit the clean one in
each package.  The JAX package's ``csr.dot`` products on these matrices
take its ELL route, whose rows XLA sums in another order than torch:
those are held at 1e-5 across the packages.
"""

import gc
import os
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse
from legate_sparse_tpu import engine as jengine
from legate_sparse_tpu import obs as jobs
from legate_sparse_tpu import resilience as jresil
from legate_sparse_tpu.settings import settings as jsettings

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import engine as tengine
from legate_sparse_tpu_torch import obs as tobs
from legate_sparse_tpu_torch import resilience as tresil
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.resilience import deadline as tdeadline
from legate_sparse_tpu_torch.resilience import faults as tfaults
from legate_sparse_tpu_torch.resilience import outcomes as toutcomes
from legate_sparse_tpu_torch.resilience import policy as tpolicy
from legate_sparse_tpu_torch.settings import settings as tsettings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KNOBS = ("resil", "resil_retries", "resil_backoff_ms",
          "resil_backoff_mult", "resil_backoff_max_ms",
          "resil_retry_budget", "resil_breaker_k",
          "resil_breaker_cooldown_ms", "engine", "gateway")


class Pkg:
    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.engine = jengine if jax else tengine
        self.obs = jobs if jax else tobs
        self.resil = jresil if jax else tresil
        self.settings = jsettings if jax else tsettings

    def csr(self, S):
        if self.name == "jax":
            return jsparse.csr_array(S)
        return tsparse.csr_array(S, device="cpu")

    def ones(self, n):
        v = np.ones(n, np.float32)
        return v if self.name == "jax" else torch.from_numpy(v)

    def np(self, y):
        return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


PKGS = (Pkg("jax"), Pkg("torch"))
T = PKGS[1]


@pytest.fixture(autouse=True)
def _isolation():
    runtime.set_device("cpu")
    saved = [{k: getattr(p.settings, k) for k in _KNOBS} for p in PKGS]
    for p in PKGS:
        p.resil.reset()
        p.obs.reset_all()
    yield
    for p, vals in zip(PKGS, saved):
        for k, v in vals.items():
            setattr(p.settings, k, v)
        p.resil.reset()
        p.engine.reset_engine()
        p.obs.reset_all()
    runtime.set_device(None)


def resil_on(p):
    """Resilience on with fast drills (no backoff sleeps)."""
    p.settings.resil = True
    p.settings.resil_backoff_ms = 0.0
    p.settings.resil_breaker_cooldown_ms = 40.0
    p.resil.reset()


def rand_sp(n=300, seed=0):
    return sp.random(n, n, density=0.04, random_state=seed, format="csr",
                     dtype=np.float32)


def both(drill):
    """``drill(p)`` on each package: their ``resil.*`` counters equal;
    returns {name: drill's value}."""
    out = {p.name: drill(p) for p in PKGS}
    assert (T.obs.counters.snapshot("resil.")
            == PKGS[0].obs.counters.snapshot("resil."))
    return out


# ---------------------------------------------------------------------------
# the vocabulary and the catalog
# ---------------------------------------------------------------------------
def test_catalog_and_kinds_equal_jax():
    assert tfaults.CATALOG.keys() == jresil.faults.CATALOG.keys()
    assert tfaults.KINDS == jresil.faults.KINDS


def test_rejected_reason_typed_vocabulary():
    assert toutcomes.REJECT_REASONS == jresil.outcomes.REJECT_REASONS
    assert toutcomes.Rejected(site="s.x").reason == "deadline_shed"
    assert toutcomes.Rejected(site="s.x",
                              reason="deadline").reason == "deadline_shed"
    for reason in toutcomes.REJECT_REASONS:
        assert toutcomes.Rejected(site="s.x", reason=reason).reason == reason
    with pytest.raises(ValueError):
        toutcomes.Rejected(site="s.x", reason="because")
    for cls in (tresil.DeadlineExceeded, tresil.DeviceLost,
                tresil.CircuitOpenError):
        assert issubclass(cls, tresil.FinalOutcomeError)
    assert issubclass(tresil.FinalOutcomeError, tresil.ResilienceError)


def test_fault_point_validation():
    resil_on(T)
    with pytest.raises(ValueError, match="unknown fault site"):
        tresil.inject("no.such.site")
    with pytest.raises(ValueError, match="unknown fault kind"):
        tresil.inject("csr.dot", kind="meltdown")
    with pytest.raises(ValueError, match="not in catalog"):
        tresil.fault_point("no.such.site")
    tresil.inject("csr.dot", kind="device_loss", device=3)
    with pytest.raises(tresil.DeviceLost) as ei:
        tresil.fault_point("csr.dot")
    assert ei.value.device == 3


def test_probabilistic_schedule_equals_jax():
    """``p < 1`` fires on the same calls as the JAX package's (the
    seeded LCG), whatever the process's RNG state."""
    def drill(p):
        resil_on(p)
        p.resil.inject("engine.exec.queue", kind="latency", count=50,
                       p=0.3, seed=11, latency_ms=0.0)
        for _ in range(40):
            p.resil.fault_point("engine.exec.queue")
        return p.resil.faults.armed("engine.exec.queue")

    out = both(drill)
    assert out["torch"] == out["jax"]
    assert 0 < out["torch"]["engine.exec.queue"]["fired"] < 40


def test_nonfinite_poisons_a_copy():
    resil_on(T)
    y = torch.ones(4)
    tresil.inject("csr.dot", kind="nonfinite")
    z = tresil.fault_point("csr.dot", y)
    assert torch.isnan(z[-1]) and not torch.isnan(z[:-1]).any()
    assert not torch.isnan(y).any()


def test_injection_skipped_while_compiling(monkeypatch):
    resil_on(T)
    tresil.inject("csr.dot", kind="error")
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert tresil.fault_point("csr.dot", 1) == 1
    assert tobs.counters.get("resil.fault.trace_skipped") == 1
    assert tfaults.fired("csr.dot") == 0


# ---------------------------------------------------------------------------
# inert when off
# ---------------------------------------------------------------------------
def test_inert_when_off():
    assert tsettings.resil is False
    A = T.csr(rand_sp(seed=3))
    tresil.inject("csr.dot", kind="error")      # armed, but off
    y = A @ T.ones(300)
    assert tobs.counters.snapshot("resil.") == {}
    assert torch.equal(y, A @ T.ones(300))


# ---------------------------------------------------------------------------
# per-site drills: fail twice, then succeed, bit for bit
# ---------------------------------------------------------------------------
def drill_site(p, site, run):
    clean = p.np(run())
    p.resil.inject(site, kind="error", count=2)
    recovered = p.np(run())
    assert p.obs.counters.get(f"resil.retry.{site}") == 2
    assert p.resil.faults.fired(site) == 2
    assert np.array_equal(clean, recovered), site
    p.resil.faults.clear()
    return recovered


def test_drill_csr_dot():
    def drill(p):
        resil_on(p)
        A = p.csr(rand_sp(seed=1))
        return drill_site(p, "csr.dot", lambda: A @ p.ones(300))

    out = both(drill)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-5,
                               atol=1e-5)


def test_drill_engine_dispatch_and_plan_build():
    def drill(p):
        resil_on(p)
        p.settings.engine = True
        p.engine.reset_engine()
        A = p.csr(rand_sp(seed=2))
        y = drill_site(p, "engine.exec.dispatch", lambda: A @ p.ones(300))
        p.resil.inject("engine.plan.build", kind="error", count=2)
        y2 = p.np(p.engine.Engine().matvec(A, p.ones(300)))
        assert p.obs.counters.get("resil.retry.engine.plan.build") == 2
        assert np.array_equal(y, y2)
        p.resil.faults.clear()
        return y

    out = both(drill)
    assert np.array_equal(out["torch"], out["jax"])


def test_drill_executor_queue_degrades_inline():
    def drill(p):
        resil_on(p)
        p.settings.engine = True
        A = p.csr(rand_sp(seed=7))
        ex = p.engine.RequestExecutor(p.engine.Engine(), max_batch=4,
                                      queue_depth=16, timeout_ms=0)
        try:
            f0 = ex.submit(A, p.ones(300))
            ex.flush()
            p.resil.inject("engine.exec.queue", kind="error", count=1)
            f1 = ex.submit(A, p.ones(300))       # served inline now
            assert f1.done()
        finally:
            ex.shutdown()
        assert p.obs.counters.get("resil.exec.queue_fault_inline") == 1
        return p.np(f0.result(timeout=30)), p.np(f1.result(timeout=30))

    out = both(drill)
    np.testing.assert_allclose(out["torch"][1], out["torch"][0],
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(out["torch"][0], out["jax"][0])


def test_nonfinite_fault_on_spgemm_is_noop():
    resil_on(T)
    A = T.csr(rand_sp(seed=22))
    clean = (A @ A).toarray()
    tresil.inject("csr.dot", kind="nonfinite", count=1)
    out = (A @ A).toarray()
    assert tfaults.fired("csr.dot") == 1
    assert tobs.counters.get("resil.retry.csr.dot") == 0
    assert torch.equal(out, clean)


def test_nonfinite_fault_on_spmv_poisons_result():
    resil_on(T)
    A = T.csr(rand_sp(seed=22))
    tresil.inject("csr.dot", kind="nonfinite", count=1)
    y = A @ T.ones(300)
    assert torch.isnan(y[-1]) and not torch.isnan(y[:-1]).any()


# ---------------------------------------------------------------------------
# breakers and budgets
# ---------------------------------------------------------------------------
def test_breaker_opens_at_k_and_recovers():
    def drill(p):
        resil_on(p)
        p.settings.resil_retries = 0
        p.settings.resil_breaker_k = 3
        A = p.csr(rand_sp(seed=4))
        x = p.ones(300)
        p.resil.inject("csr.dot", kind="error", count=3)
        for _ in range(3):
            with pytest.raises(p.resil.InjectedFault):
                A @ x
        assert p.resil.breaker("csr.dot").state == "open"
        with pytest.raises(p.resil.CircuitOpenError):
            A @ x
        time.sleep(p.settings.resil_breaker_cooldown_ms / 1e3 + 0.01)
        y = A @ x
        assert p.resil.breaker("csr.dot").state == "closed"
        return tuple(p.np(y).shape)

    assert both(drill)["torch"] == (300,)
    assert tobs.counters.get("resil.breaker.csr.dot.trips") == 1
    assert tobs.counters.get("resil.breaker.close") == 1


def test_breaker_half_open_failure_reopens():
    def drill(p):
        resil_on(p)
        p.settings.resil_retries = 0
        p.settings.resil_breaker_k = 2
        A = p.csr(rand_sp(seed=8))
        p.resil.inject("csr.dot", kind="error", count=3)
        for _ in range(2):
            with pytest.raises(p.resil.InjectedFault):
                A @ p.ones(300)
        time.sleep(p.settings.resil_breaker_cooldown_ms / 1e3 + 0.01)
        with pytest.raises(p.resil.InjectedFault):
            A @ p.ones(300)
        return p.resil.breaker("csr.dot").state

    assert both(drill)["torch"] == "open"
    assert tobs.counters.get("resil.breaker.csr.dot.trips") == 2


def test_breaker_flips_engine_ladder():
    """An open engine.exec.dispatch breaker short-circuits the engine
    rung: A @ x keeps serving through the plain dispatch (counted as
    engine.route.error), and the half-open probe restores the engine."""
    A = T.csr(rand_sp(seed=9))
    x = T.ones(300)
    y_plain = A @ x
    resil_on(T)
    T.settings.engine = True
    T.settings.resil_retries = 0
    T.settings.resil_breaker_k = 2
    tresil.inject("engine.exec.dispatch", kind="error", count=2)
    for _ in range(2):
        assert torch.equal(A @ x, y_plain)
        assert A.spmv_path != "engine"
    assert tresil.breaker("engine.exec.dispatch").state == "open"
    assert torch.equal(A @ x, y_plain)
    assert tobs.counters.get(
        "resil.breaker.engine.exec.dispatch.short_circuit") == 1
    assert tobs.counters.get("engine.route.error") == 3
    time.sleep(T.settings.resil_breaker_cooldown_ms / 1e3 + 0.01)
    y2 = A @ x
    assert A.spmv_path == "engine"
    assert tresil.breaker("engine.exec.dispatch").state == "closed"
    np.testing.assert_allclose(y2.numpy(), y_plain.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_retry_budget_bounds_amplification():
    def drill(p):
        resil_on(p)
        p.settings.resil_retries = 5
        p.settings.resil_retry_budget = 1
        p.resil.reset()
        A = p.csr(rand_sp(seed=10))
        p.resil.inject("csr.dot", kind="error", count=10)
        with pytest.raises(p.resil.InjectedFault):
            A @ p.ones(300)

    both(drill)
    assert tobs.counters.get("resil.retry.csr.dot") == 1
    assert tobs.counters.get("resil.retry.budget_exhausted") == 1


def test_retry_loop_stops_on_self_tripped_breaker():
    def drill(p):
        resil_on(p)
        p.settings.resil_retries = 5
        p.settings.resil_breaker_k = 2
        p.settings.resil_breaker_cooldown_ms = 60000.0
        A = p.csr(rand_sp(seed=21))
        p.resil.inject("csr.dot", kind="error", count=10)
        with pytest.raises(p.resil.InjectedFault):
            A @ p.ones(300)
        return p.resil.faults.fired("csr.dot")

    assert both(drill)["torch"] == 2
    assert tobs.counters.get("resil.retry.csr.dot") == 1


def test_probe_release_on_final_outcome_verdict():
    resil_on(T)
    T.settings.resil_retries = 0
    T.settings.resil_breaker_k = 2
    T.settings.resil_breaker_cooldown_ms = 30.0

    def boom():
        raise RuntimeError("transient")

    for _ in range(2):
        with pytest.raises(RuntimeError):
            tpolicy.run("csr.dot", boom)
    assert tpolicy.breaker("csr.dot").state == "open"
    time.sleep(0.05)

    def verdict():
        raise toutcomes.DeadlineExceeded("csr.dot")

    with pytest.raises(toutcomes.DeadlineExceeded):
        tpolicy.run("csr.dot", verdict)
    assert tpolicy.run("csr.dot", lambda: 42) == 42
    assert tpolicy.breaker("csr.dot").state == "closed"


def test_open_plan_build_breaker_flips_ladder_no_poison():
    resil_on(T)
    T.settings.engine = True
    T.settings.resil_retries = 0
    T.settings.resil_breaker_k = 1
    T.settings.resil_breaker_cooldown_ms = 60000.0
    A = T.csr(rand_sp(n=520, seed=11))
    x = T.ones(520)
    br = tpolicy.breaker("engine.plan.build")
    br.record_failure()
    assert br.state == "open"
    y = A @ x                                    # ladder flip, no raise
    assert A.spmv_path != "engine"
    T.settings.engine = False
    expect = A @ x
    assert torch.equal(y, expect)
    T.settings.engine = True
    tpolicy.reset()
    y2 = A @ x
    assert A.spmv_path == "engine"
    np.testing.assert_allclose(y2.numpy(), expect.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert tobs.counters.get("engine.plan.failed_fast") == 0


def test_breaker_cooldown_on_frozen_monotonic_clock(monkeypatch):
    now = {"ns": 1_000_000_000}
    monkeypatch.setattr(time, "monotonic_ns", lambda: now["ns"])
    br = tpolicy.CircuitBreaker("drill.site", k=1, cooldown_s=0.05)
    br.record_failure()
    assert br.state == "open" and not br.allow()
    now["ns"] += 49_000_000
    assert not br.allow()
    now["ns"] += 2_000_000
    assert br.allow() and br.state == "half_open"
    assert not br.allow()                        # one probe at a time
    br.record_success()
    assert br.state == "closed"


def test_deadline_tracks_patched_monotonic_clock(monkeypatch):
    now = {"ns": 5_000_000_000}
    monkeypatch.setattr(time, "monotonic_ns", lambda: now["ns"])
    assert tdeadline.current() is None and not tdeadline.expired()
    with tdeadline.scope(100.0):
        d = tdeadline.current()
        assert abs(d.remaining_ms() - 100.0) < 1e-9 and not d.expired()
        now["ns"] += 60_000_000
        assert abs(tdeadline.current().remaining_ms() - 40.0) < 1e-9
        now["ns"] += 40_000_000
        assert d.expired() and tdeadline.expired()
        with tdeadline.scope(10_000.0):          # sooner wins
            assert tdeadline.current().t_end_ns == d.t_end_ns
    assert tdeadline.current() is None


def test_drill_gateway_admit_degrades_inline():
    """An injected ``gateway.admit`` fault serves that request inline
    through A.dot; the queue stays consistent for the next one."""
    def drill(p):
        resil_on(p)
        p.settings.gateway = True
        A = p.csr(rand_sp(seed=26))
        gw = p.engine.Gateway(p.engine.Engine(), max_batch=8,
                              timeout_ms=0.0)
        try:
            p.resil.inject("gateway.admit", kind="error", count=1)
            f1 = gw.submit(A, p.ones(300), tenant="a")
            assert f1.done()
            f2 = gw.submit(A, p.ones(300), tenant="a")
            gw.flush()
        finally:
            gw.shutdown()
        return (p.obs.counters.get("gateway.admit_fault_inline"),
                p.np(f1.result(timeout=30)), p.np(f2.result(timeout=30)))

    out = both(drill)
    assert out["torch"][0] == out["jax"][0] == 1
    assert np.array_equal(out["torch"][1], T.np(
        T.csr(rand_sp(seed=26)).dot(T.ones(300))))
    np.testing.assert_allclose(out["torch"][2], out["torch"][1],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# deadlines on the executor
# ---------------------------------------------------------------------------
def test_executor_sheds_expired_at_admission():
    def drill(p):
        resil_on(p)
        p.settings.engine = True
        A = p.csr(rand_sp(seed=11))
        ex = p.engine.RequestExecutor(p.engine.Engine(), max_batch=8,
                                      queue_depth=64, timeout_ms=0)
        try:
            with p.resil.deadline.scope(0.0):
                out = ex.submit(A, p.ones(300)).result(timeout=10)
        finally:
            ex.shutdown()
        return (type(out).__name__, out.site, out.reason, out.deadline_ms)

    out = both(drill)
    assert out["torch"] == out["jax"] == (
        "Rejected", "engine.exec.queue", "deadline_shed", 0.0)


def test_executor_sheds_expired_at_flush():
    resil_on(T)
    T.settings.engine = True
    A = T.csr(rand_sp(seed=12))
    ex = tengine.RequestExecutor(tengine.Engine(), max_batch=8,
                                 queue_depth=64, timeout_ms=0)
    try:
        with tdeadline.scope(30.0):
            doomed = ex.submit(A, T.ones(300))
        healthy = ex.submit(A, T.ones(300))
        time.sleep(0.05)
        ex.flush()
        out = doomed.result(timeout=10)
        y = healthy.result(timeout=30)
    finally:
        ex.shutdown()
    assert isinstance(out, tresil.Rejected)
    assert out.site == "engine.exec.dispatch" and out.waited_ms >= 30.0
    assert torch.isfinite(y).all()
    assert tobs.counters.get("resil.shed.engine.exec.dispatch") == 1


# ---------------------------------------------------------------------------
# lifetimes: atexit drain, collectability, shutdown race
# ---------------------------------------------------------------------------
_ATEXIT_DRILL = r"""
import atexit, sys
import numpy as np
import scipy.sparse as sp
import torch
from legate_sparse_tpu_torch import runtime
runtime.set_device("cpu")
import legate_sparse_tpu_torch as sparse
from legate_sparse_tpu_torch.engine import Engine, RequestExecutor
from legate_sparse_tpu_torch.settings import settings

A = sparse.csr_array(sp.random(200, 200, density=0.05, random_state=0,
                               format="csr", dtype=np.float32))
x = torch.ones(200)
expected = A @ x
holder = {}

def check():
    # Runs after the executor's own drain (atexit is LIFO).
    fut = holder.get("fut")
    ok = (fut is not None and fut.done() and fut.exception() is None
          and torch.allclose(fut.result(), expected))
    sys.stdout.write("DISPATCHED=%d\n" % (1 if ok else 0))
    sys.stdout.flush()

atexit.register(check)
settings.engine = True
ex = RequestExecutor(Engine(), max_batch=8, queue_depth=64,
                     timeout_ms=60000.0)
holder["fut"] = ex.submit(A, x)
assert ex.pending() == 1
"""


def test_executor_atexit_drains_queued_requests(tmp_path):
    script = tmp_path / "atexit_drill.py"
    script.write_text(_ATEXIT_DRILL)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "DISPATCHED=1" in r.stdout, (r.stdout, r.stderr[-2000:])


def test_executor_abandoned_is_collectable():
    ex = tengine.RequestExecutor(tengine.Engine(), max_batch=4,
                                 queue_depth=8, timeout_ms=0)
    ref = weakref.ref(ex)
    del ex
    gc.collect()
    assert ref() is None


def test_executor_shutdown_race_resolves_every_future():
    resil_on(T)
    T.settings.engine = True
    A = T.csr(rand_sp(seed=24))
    x = T.ones(300)
    expected = tengine.Engine().matvec(A, x)
    for _trial in range(3):
        ex = tengine.RequestExecutor(tengine.Engine(), max_batch=64,
                                     queue_depth=256, timeout_ms=60000.0)
        futs, raised = [], []
        barrier = threading.Barrier(5)

        def submitter():
            barrier.wait(timeout=30)
            for _i in range(8):
                try:
                    futs.append(ex.submit(A, x))
                except RuntimeError:
                    raised.append(1)

        def closer():
            barrier.wait(timeout=30)
            ex.close()

        threads = ([threading.Thread(target=submitter) for _ in range(4)]
                   + [threading.Thread(target=closer)])
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        finally:
            ex.close()
        assert len(futs) + len(raised) == 32
        for f in futs:
            out = f.result(timeout=30)
            if not isinstance(out, tresil.Rejected):
                assert torch.equal(out, expected)


def test_gateway_shutdown_race_resolves_every_future():
    """Concurrent submits against ``close()``: every accepted future
    resolves (or its submit raised), none hangs."""
    p = T
    resil_on(p)
    p.settings.gateway = True
    A = p.csr(rand_sp(seed=25))
    x = p.ones(300)
    for _trial in range(3):
        gw = p.engine.Gateway(p.engine.Engine(), max_batch=64,
                              queue_depth=256, tenant_quota=64, rate=0.0,
                              burst=16.0, slack_ms=5.0, timeout_ms=60000.0)
        futs, raised = [], []
        barrier = threading.Barrier(5)

        def submitter(name):
            barrier.wait(timeout=30)
            for _i in range(8):
                try:
                    futs.append(gw.submit(A, x, tenant=name))
                except RuntimeError:
                    raised.append(1)

        def closer():
            barrier.wait(timeout=30)
            gw.close()

        threads = ([threading.Thread(target=submitter, args=(f"t{i}",))
                    for i in range(4)]
                   + [threading.Thread(target=closer)])
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        finally:
            gw.close()
        assert len(futs) + len(raised) == 32
        for f in futs:
            out = f.result(timeout=30)
            if not isinstance(out, tresil.Rejected):
                assert torch.equal(out, p.engine.Engine().matvec(A, x))
