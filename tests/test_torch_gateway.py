# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's multi-tenant admission gateway
(``legate_sparse_tpu_torch/engine/gateway.py``) against the JAX
package's on the CPU.

Mirrors ``tests/test_gateway.py`` (its chaos drills are in
``test_torch_chaos.py``), the bench's two-stage three-tenant gateway load
(``bench.py``'s gateway phase) and the gateway case of
``tests/test_delta.py``.  Each drill is written once against an adapter
(``Pkg``) and run on both packages with the same scipy matrices and
numpy operands, made from a seed; the port runs on ``device="cpu"``.

Held equal between the packages: every ``gateway.*`` counter's
movement, each future's outcome (a result, or a typed ``Rejected`` with
its reason and site), and each served result, bit for bit (f32: both
engines sum each row's slots in order on the CPU).
"""

import time

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
from legate_sparse_tpu_torch.settings import settings as tsettings

_KNOBS = ("gateway", "resil", "resil_retries", "resil_backoff_ms",
          "resil_breaker_k", "resil_breaker_cooldown_ms", "delta")


class Pkg:
    """One package behind the names the drills use."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.sparse = jsparse if jax else tsparse
        self.engine = jengine if jax else tengine
        self.obs = jobs if jax else tobs
        self.resil = jresil if jax else tresil
        self.settings = jsettings if jax else tsettings
        self.Rejected = self.resil.Rejected

    def csr(self, S):
        if self.name == "jax":
            return jsparse.csr_array(S)
        return tsparse.csr_array(S, device="cpu")

    def x(self, n, seed=1):
        v = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        return v if self.name == "jax" else torch.from_numpy(v)

    def gateway(self, **kw):
        """A deterministic gateway: no drain worker (timeout_ms=0)."""
        base = dict(max_batch=64, queue_depth=128, tenant_quota=64,
                    rate=0.0, burst=16.0, slack_ms=1.0, timeout_ms=0.0)
        base.update(kw)
        return self.engine.Gateway(self.engine.Engine(), **base)


PKGS = (Pkg("jax"), Pkg("torch"))


@pytest.fixture(autouse=True)
def _isolation():
    runtime.set_device("cpu")
    saved = [{k: getattr(p.settings, k) for k in _KNOBS} for p in PKGS]
    for p in PKGS:
        p.obs.reset_all()
        p.resil.reset()
    yield
    for p, vals in zip(PKGS, saved):
        for k, v in vals.items():
            setattr(p.settings, k, v)
        p.resil.reset()
        p.engine.reset_gateway()
        p.engine.reset_engine()
        p.obs.reset_all()
    runtime.set_device(None)


def gw_on(p):
    p.settings.gateway = True


def armed(p):
    """Gateway and resilience armed, no real backoff sleeps."""
    p.settings.gateway = True
    p.settings.resil = True
    p.settings.resil_backoff_ms = 0.0
    p.resil.reset()


def random_sp(n=400, density=0.03, seed=0):
    """``sp.random`` draws exactly ``int(density*n*n)`` nonzeros: two
    seeds land in one shape bucket (the cross-matrix pack)."""
    return sp.random(n, n, density=density, format="csr",
                     random_state=np.random.default_rng(seed),
                     dtype=np.float32)


def tridiag(n=256):
    return sp.diags([np.full(n, 4.0, np.float32),
                     np.full(n - 1, -1.0, np.float32),
                     np.full(n - 1, -1.0, np.float32)], [0, 1, -1],
                    format="csr", dtype=np.float32)


def outcome(p, fut):
    """A future's outcome as plain data: ("rejected", reason, site,
    tenant), ("error", type name) or ("served", numpy result)."""
    try:
        out = fut.result(timeout=30)
    except Exception as e:          # an error outcome is compared too
        return ("error", type(e).__name__)
    if isinstance(out, p.Rejected):
        return ("rejected", out.reason, out.site, out.tenant)
    return ("served", out.numpy() if isinstance(out, torch.Tensor)
            else np.asarray(out))


def gateway_counts(p):
    return p.obs.counters.snapshot("gateway.")


def run_both(drill, exact=True):
    """Run ``drill(p)`` on each package; hold the outcomes and the
    ``gateway.*`` counters equal.  ``exact=False`` holds served results
    at 1e-5 instead: requests served inline through ``A.dot`` take the
    ELL route on these matrices, whose rows torch and XLA sum in
    different orders.  Returns the port's outcomes and counters."""
    got = {}
    for p in PKGS:
        outs = drill(p)
        got[p.name] = ([outcome(p, f) for f in outs], gateway_counts(p))
    (jo, jc), (to, tc) = got["jax"], got["torch"]
    assert tc == jc
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        assert a[0] == b[0], (a, b)
        if a[0] == "served" and exact:
            assert np.array_equal(a[1], b[1], equal_nan=True)
        elif a[0] == "served":
            np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-5)
        else:
            assert a == b
    return to, tc


# ---------------------------------------------------------------------------
# off-by-default contract
# ---------------------------------------------------------------------------
def test_gateway_off_is_bit_for_bit_and_counter_inert():
    assert tsettings.gateway is False
    p = PKGS[1]
    A = p.csr(random_sp(seed=3))
    x = p.x(400, seed=5)
    gw = p.engine.Gateway(p.engine.Engine())
    try:
        fut = gw.submit(A, x, tenant="off", qos="interactive")
        assert fut.done()
        assert torch.equal(fut.result(), A.dot(x))
    finally:
        gw.shutdown()
    assert gateway_counts(p) == {}


def test_submit_validation_is_mode_independent():
    p = PKGS[1]
    A = p.csr(random_sp(seed=3))
    gw = p.engine.Gateway(p.engine.Engine())
    try:
        with pytest.raises(ValueError, match="unknown qos"):
            gw.submit(A, p.x(400), qos="platinum")
        with pytest.raises(ValueError, match="does not match"):
            gw.submit(A, p.x(401))
    finally:
        gw.shutdown()


def test_get_gateway_singleton_and_reset():
    p = PKGS[1]
    gw_on(p)
    g1 = p.engine.get_gateway()
    assert p.engine.get_gateway() is g1
    p.engine.reset_gateway()
    assert p.engine.get_gateway() is not g1


def test_submit_after_shutdown_raises():
    p = PKGS[1]
    gw_on(p)
    gw = p.gateway()
    gw.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        gw.submit(p.csr(random_sp(seed=3)), p.x(400))


def test_qos_classes_equal_jax():
    assert tengine.QOS_CLASSES == jengine.QOS_CLASSES
    assert tengine.QOS_WEIGHTS == jengine.QOS_WEIGHTS


# ---------------------------------------------------------------------------
# WFQ batch formation
# ---------------------------------------------------------------------------
def test_wfq_interactive_leads_background():
    """Background arrives first; WFQ orders the batch by virtual finish
    tag, interactive first, with the JAX package's tags."""
    def drill(p):
        gw_on(p)
        A = p.csr(random_sp(seed=3))
        gw = p.gateway()
        try:
            futs = [gw.submit(A, p.x(400, seed=i), tenant="bg",
                              qos="background") for i in range(3)]
            futs += [gw.submit(A, p.x(400, seed=i), tenant="ia",
                               qos="interactive") for i in range(3, 6)]
            with gw._cv:
                batch = gw._pop_batch_locked()
            p.order = [(r.tenant, r.vtag) for r in batch]
            gw._dispatch(batch)
        finally:
            gw.shutdown()
        return futs

    run_both(drill)
    assert PKGS[1].order == PKGS[0].order
    assert [t for t, _ in PKGS[1].order] == ["ia"] * 3 + ["bg"] * 3


# ---------------------------------------------------------------------------
# typed admission control
# ---------------------------------------------------------------------------
def test_token_bucket_rejects_with_quota_reason():
    def drill(p):
        gw_on(p)
        A = p.csr(random_sp(seed=3))
        gw = p.gateway(rate=0.001, burst=2.0)
        try:
            futs = [gw.submit(A, p.x(400, seed=s), tenant="limited")
                    for s in range(4)]
            gw.flush()
        finally:
            gw.shutdown()
        return futs

    outs, c = run_both(drill)
    assert [o[0] for o in outs] == ["served"] * 2 + ["rejected"] * 2
    assert outs[2][1:] == ("quota", "gateway.admit", "limited")
    assert c["gateway.rejected.quota"] == 2
    assert c["gateway.tenant.limited.served"] == 2


def test_tenant_quota_rejects_noisy_tenant_only():
    def drill(p):
        gw_on(p)
        A = p.csr(random_sp(seed=3))
        gw = p.gateway(tenant_quota=2)
        try:
            futs = [gw.submit(A, p.x(400, seed=s), tenant="noisy")
                    for s in range(5)]
            futs.append(gw.submit(A, p.x(400, seed=5), tenant="calm",
                                  qos="interactive"))
            gw.flush()
        finally:
            gw.shutdown()
        return futs

    outs, c = run_both(drill)
    assert c["gateway.rejected.queue_full"] == 3
    assert "gateway.tenant.calm.shed" not in c
    assert outs[-1][0] == "served"


def test_backpressure_evicts_weakest_class():
    def drill(p):
        gw_on(p)
        A = p.csr(random_sp(seed=3))
        gw = p.gateway(queue_depth=2)
        try:
            futs = [gw.submit(A, p.x(400, seed=0), tenant="ia",
                              qos="interactive"),
                    gw.submit(A, p.x(400, seed=1), tenant="bg",
                              qos="background"),
                    gw.submit(A, p.x(400, seed=2), tenant="ia",
                              qos="interactive")]
            gw.flush()
        finally:
            gw.shutdown()
        return futs

    outs, c = run_both(drill)
    assert outs[1][1:] == ("queue_full", "gateway.admit", "bg")
    assert c["gateway.evicted"] == 1


def test_backpressure_rejects_weak_incoming():
    def drill(p):
        gw_on(p)
        A = p.csr(random_sp(seed=3))
        gw = p.gateway(queue_depth=2)
        try:
            futs = [gw.submit(A, p.x(400, seed=s), tenant="ia",
                              qos="interactive") for s in range(2)]
            futs.append(gw.submit(A, p.x(400, seed=2), tenant="bg",
                                  qos="background"))
            gw.flush()
        finally:
            gw.shutdown()
        return futs

    outs, _ = run_both(drill)
    assert outs[2][1:] == ("queue_full", "gateway.admit", "bg")
    assert [o[0] for o in outs[:2]] == ["served"] * 2


def test_ineligible_matrix_served_inline():
    """A banded matrix skips the queue: inline service through A.dot."""
    def drill(p):
        gw_on(p)
        A = p.csr(tridiag())
        gw = p.gateway()
        try:
            fut = gw.submit(A, p.x(256, seed=9), tenant="banded")
            assert fut.done()
        finally:
            gw.shutdown()
        return [fut]

    outs, c = run_both(drill)
    assert c["gateway.inline"] == 1
    assert c["gateway.tenant.banded.served"] == 1
    T = PKGS[1].csr(tridiag())
    assert np.array_equal(outs[0][1], T.dot(PKGS[1].x(256, seed=9)).numpy())


# ---------------------------------------------------------------------------
# deadline-aware batching
# ---------------------------------------------------------------------------
def test_urgent_request_dispatches_immediately():
    def drill(p):
        armed(p)
        A = p.csr(random_sp(seed=3))
        gw = p.gateway(slack_ms=10_000.0)
        try:
            f0 = gw.submit(A, p.x(400, seed=0), tenant="calm")
            assert not f0.done()
            with p.resil.deadline.scope(5_000.0):
                f1 = gw.submit(A, p.x(400, seed=1), tenant="urgent",
                               qos="interactive")
            assert f0.done() and f1.done()
        finally:
            gw.shutdown()
        return [f0, f1]

    _, c = run_both(drill)
    assert c["gateway.dispatches"] == 1
    assert c["gateway.dispatched_requests"] == 2


def test_expired_deadline_shed_at_admission():
    def drill(p):
        armed(p)
        A = p.csr(random_sp(seed=3))
        gw = p.gateway()
        try:
            with p.resil.deadline.scope(0.0):
                fut = gw.submit(A, p.x(400), tenant="storm")
        finally:
            gw.shutdown()
        assert fut.result(timeout=5).deadline_ms == 0.0
        return [fut]

    outs, _ = run_both(drill)
    assert outs[0][1:] == ("deadline_shed", "gateway.admit", "storm")


def test_deadline_expiring_in_queue_shed_at_dispatch():
    p = PKGS[1]
    armed(p)
    A = p.csr(random_sp(seed=3))
    gw = p.gateway()
    try:
        with p.resil.deadline.scope(50.0):
            fut = gw.submit(A, p.x(400), tenant="late")
        assert not fut.done()
        time.sleep(0.06)
        gw.flush()
        out = fut.result(timeout=5)
    finally:
        gw.shutdown()
    assert isinstance(out, p.Rejected)
    assert (out.reason, out.site) == ("deadline_shed", "gateway.dispatch")
    assert out.waited_ms >= 50.0


def test_breaker_degraded_mode():
    """Dispatch breaker open: deferrable classes shed ``breaker``;
    interactive traffic is served inline."""
    def drill(p):
        armed(p)
        A = p.csr(random_sp(seed=3))
        br = p.resil.policy.breaker("gateway.dispatch")
        for _ in range(p.settings.resil_breaker_k):
            br.record_failure()
        assert br.state == "open"
        gw = p.gateway()
        try:
            futs = [gw.submit(A, p.x(400, seed=2), tenant="bt",
                              qos="batch"),
                    gw.submit(A, p.x(400, seed=2), tenant="ia",
                              qos="interactive")]
        finally:
            gw.shutdown()
        return futs

    outs, c = run_both(drill, exact=False)
    assert outs[0][1] == "breaker" and outs[1][0] == "served"
    p = PKGS[1]
    assert np.array_equal(outs[1][1], p.csr(random_sp(seed=3)).dot(
        p.x(400, seed=2)).numpy())
    assert c["gateway.rejected.breaker"] == 1
    assert c["gateway.breaker_inline"] == 1


def test_dispatch_fault_served_inline():
    """An injected ``gateway.dispatch`` fault feeds the breaker and the
    batch is served request by request through A.dot."""
    def drill(p):
        armed(p)
        A1, A2 = p.csr(random_sp(seed=3)), p.csr(random_sp(seed=4))
        gw = p.gateway(max_batch=4)
        try:
            p.resil.inject("gateway.dispatch", kind="error", count=1)
            futs = [gw.submit(M, p.x(400, seed=s), tenant=f"t{s % 2}")
                    for s, M in enumerate([A1, A2, A1, A2])]
            assert all(f.done() for f in futs)
        finally:
            gw.shutdown()
        p.fired = p.resil.faults.fired("gateway.dispatch")
        return futs

    outs, c = run_both(drill, exact=False)
    assert c["gateway.dispatch_fault_inline"] == 1
    p = PKGS[1]
    for s, (o, seed) in enumerate(zip(outs, [3, 4, 3, 4])):
        assert np.array_equal(o[1], p.csr(random_sp(seed=seed)).dot(
            p.x(400, seed=s)).numpy())
    assert "gateway.packed" not in c
    assert PKGS[1].fired == 1
    assert tobs.counters.get("resil.fault.gateway.dispatch.injected") == 1


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------
def test_cross_matrix_batch_packs_one_dispatch():
    def drill(p):
        gw_on(p)
        A1, A2 = p.csr(random_sp(seed=3)), p.csr(random_sp(seed=4))
        assert A1.nnz == A2.nnz
        gw = p.gateway(max_batch=4)
        try:
            futs = [gw.submit(M, p.x(400, seed=s), tenant=f"t{s % 2}")
                    for s, M in enumerate([A1, A2, A1, A2])]
            assert all(f.done() for f in futs)
        finally:
            gw.shutdown()
        return futs

    outs, c = run_both(drill)
    assert c["gateway.dispatches"] == 1 and c["gateway.packed"] == 1
    assert c["gateway.dispatched_requests"] == 4
    p = PKGS[1]
    eng = p.engine.Engine()
    for s, (o, M) in enumerate(zip(outs, [3, 4, 3, 4])):
        y = eng.matvec(p.csr(random_sp(seed=M)), p.x(400, seed=s))
        assert np.array_equal(o[1], y.numpy())


def test_same_matrix_batch_is_bitwise():
    def drill(p):
        gw_on(p)
        A = p.csr(random_sp(seed=3))
        gw = p.gateway()
        try:
            futs = [gw.submit(A, p.x(400, seed=s), tenant="one")
                    for s in range(3)]
            gw.flush()
        finally:
            gw.shutdown()
        return futs

    outs, _ = run_both(drill)
    p = PKGS[1]
    A = p.csr(random_sp(seed=3))
    for s, o in enumerate(outs):
        assert np.array_equal(o[1], p.engine.Engine().matvec(
            A, p.x(400, seed=s)).numpy())


def test_drain_worker_serves_on_timeout():
    p = PKGS[1]
    gw_on(p)
    A = p.csr(random_sp(seed=3))
    gw = p.gateway(timeout_ms=2.0)
    try:
        futs = [gw.submit(A, p.x(400, seed=s), tenant="w")
                for s in range(3)]
        for f in futs:
            assert tuple(f.result(timeout=30).shape) == (400,)
    finally:
        gw.shutdown()
    assert gw._worker is None or not gw._worker.is_alive()


# ---------------------------------------------------------------------------
# the bench's two-stage three-tenant load
# ---------------------------------------------------------------------------
def engine_config(n, nnz_per_row=11, seed=7):
    """``bench.py::_engine_config``: random columns, one heavy row that
    breaks the ELL and BSR budgets, nnz = nnz_per_row * (n + 63)."""
    rng = np.random.default_rng(seed)
    counts = np.full(n, nnz_per_row, dtype=np.int64)
    counts[0] = min(64 * nnz_per_row, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, n, size=nnz).astype(np.int32)
    order = np.lexsort((indices, np.repeat(np.arange(n), counts)))
    data = rng.standard_normal(nnz).astype(np.float32)
    return sp.csr_matrix((data, indices[order], indptr), shape=(n, n))


def two_stage_load(p, mats, x, extra=()):
    """Stage A (max_batch=4): interactive alternates two matrices of one
    bucket (packed batches), batch on a third, background floods the
    first.  Stage B (flush-only, tenant_quota=8): the same submissions;
    the background flood takes 24 ``queue_full`` rejections.  ``extra``
    tenants (name, matrix, count) are served inline in each stage."""
    A1, A2, A3 = mats
    futs = []
    for kw in (dict(max_batch=4, queue_depth=128, tenant_quota=64),
               dict(max_batch=32, queue_depth=128, tenant_quota=8)):
        gw = p.engine.Gateway(p.engine.Engine(), rate=0.0, burst=16.0,
                              slack_ms=5.0, timeout_ms=0.0, **kw)
        try:
            for i in range(8):
                futs.append(gw.submit(A1 if i % 2 == 0 else A2, x,
                                      tenant="interactive",
                                      qos="interactive"))
            for _ in range(8):
                futs.append(gw.submit(A3, x, tenant="batch", qos="batch"))
            for _ in range(32):
                futs.append(gw.submit(A1, x, tenant="background",
                                      qos="background"))
            for name, M, xm, count in extra:
                for _ in range(count):
                    futs.append(gw.submit(M, xm, tenant=name,
                                          qos="interactive"))
            gw.flush()
            for f in futs:
                f.result(timeout=120)
        finally:
            gw.shutdown()
    return futs


# The load's ``gateway.*`` totals: ``chip_smoke.py``'s
# ``P16_GATEWAY_TOTALS``, which phase 16 holds on the card.
TWO_STAGE_TOTALS = {
    "gateway.admitted": 72, "gateway.dispatched_requests": 72,
    "gateway.dispatches": 13, "gateway.outcome.served": 72,
    "gateway.outcome.shed": 24, "gateway.packed": 3,
    "gateway.rejected.queue_full": 24, "gateway.submitted": 96,
    "gateway.tenant.background.served": 40,
    "gateway.tenant.background.shed": 24,
    "gateway.tenant.background.submitted": 64,
    "gateway.tenant.batch.served": 16,
    "gateway.tenant.batch.submitted": 16,
    "gateway.tenant.interactive.served": 16,
    "gateway.tenant.interactive.submitted": 16,
}


def test_bench_two_stage_load_counts_equal_jax():
    n = (1 << 12) - 91

    def drill(p):
        gw_on(p)
        mats = [p.csr(engine_config(n, seed=s)) for s in (7, 13, 29)]
        x = p.x(n, seed=0) * 0 + 1
        return two_stage_load(p, mats, x)

    outs, c = run_both(drill)
    assert c == TWO_STAGE_TOTALS
    assert sum(o[0] == "served" for o in outs) == 72


# ---------------------------------------------------------------------------
# the delta layer behind the gateway
# ---------------------------------------------------------------------------
def test_gateway_routes_delta_and_serves_two_terms():
    """With ``settings.delta`` on a submitted ``DeltaCSR`` is pinned to
    its current view at admission and served inline (both terms)."""
    from legate_sparse_tpu_torch.delta import DeltaCSR

    p = PKGS[1]
    gw_on(p)
    tsettings.delta = True
    S = tridiag(64)
    D = DeltaCSR(p.csr(S))
    D.update([0], [0], [7.5])
    x = p.x(64, seed=3)
    gw = p.gateway()
    try:
        y = gw.submit(D, x, tenant="mut", qos="interactive").result(
            timeout=30)
    finally:
        gw.shutdown()
    S2 = S.tolil()
    S2[0, 0] = 7.5
    np.testing.assert_allclose(y.numpy(), S2.tocsr() @ x.numpy().astype(
        np.float64), rtol=1e-6, atol=1e-6)
    c = tobs.counters.snapshot("delta.")
    assert c.get("delta.routes") == 1 and c.get("delta.served") == 1


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------
def test_request_trace_ids_draw_flow_arcs():
    """Each request's admit span carries its trace id, the batch span
    names its members, and the Chrome trace draws one arc per request."""
    p = PKGS[1]
    gw_on(p)
    A = p.csr(random_sp(seed=3))
    tobs.enable()
    try:
        gw = p.gateway()
        try:
            futs = [gw.submit(A, p.x(400, seed=s), tenant="t")
                    for s in range(2)]
            gw.flush()
            for f in futs:
                f.result(timeout=30)
        finally:
            gw.shutdown()
        recs = [r for r in tobs.records() if r.get("type") == "span"]
        admits = [r["attrs"]["trace_id"] for r in recs
                  if r["name"] == "gateway.admit"]
        batch = [r for r in recs if r["name"] == "gateway.batch"]
        doc = tobs.to_chrome_trace()
    finally:
        tobs.disable()
    assert len(admits) == 2 and len(set(admits)) == 2
    assert batch and batch[0]["attrs"]["trace_ids"] == admits
    flows = [e for e in doc["traceEvents"] if e.get("cat") == "flow"]
    assert sorted({e["id"] for e in flows}) == sorted(admits)
    assert {e["ph"] for e in flows} == {"s", "f"}
