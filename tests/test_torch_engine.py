# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's execution engine (``legate_sparse_tpu_torch/engine``:
bucketing, the plan cache, the executor, routing) against the JAX
package's on the CPU.

Mirrors ``tests/test_engine.py``.  The same scipy matrices and numpy
operands, made from a seed, go to both packages; the port runs on
``device="cpu"``.

Tolerances.  A bucketed product is held bit for bit with the port's
unpadded csr-rowids product and, in f32 and f64, with the JAX package's
bucketed product (both sum each row's slots in order on the CPU);
complex products round differently in torch and XLA and are held at
1e-6.  The engine-routed CG is bit for bit the port's engine-off solve
and within 1e-10 (f64) of the JAX package's engine-routed solve, whose
dot products sum in another order.  The ``engine.plan.*`` and
``engine.exec.*`` counts equal the JAX package's over the same calls.
"""

import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse
import legate_sparse_tpu.linalg as jlinalg
from legate_sparse_tpu import obs as jobs
from legate_sparse_tpu.engine import Engine as JEngine
from legate_sparse_tpu.engine import RequestExecutor as JExecutor
from legate_sparse_tpu.settings import settings as jsettings

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch import obs as tobs
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.engine import Engine, RequestExecutor
from legate_sparse_tpu_torch.engine import bucket, k_bucket, next_pow2
from legate_sparse_tpu_torch.engine import core as engine_core
from legate_sparse_tpu_torch.engine import plan_cache
from legate_sparse_tpu_torch.ops import spmv as tspmv
from legate_sparse_tpu_torch.settings import settings as tsettings

_KNOBS = ("engine", "ell_max_expand", "dia_max_expand",
          "engine_bucket_ladder", "engine_min_bucket", "autotune")


@pytest.fixture(autouse=True)
def _isolation():
    runtime.set_device("cpu")
    saved = [{k: getattr(s, k) for k in _KNOBS}
             for s in (jsettings, tsettings)]
    jobs.reset_all()
    tobs.reset_all()
    yield
    for s, vals in zip((jsettings, tsettings), saved):
        for k, v in vals.items():
            if getattr(s, k) != v:
                setattr(s, k, v)
    engine_core.reset_engine()
    jobs.reset_all()
    tobs.reset_all()
    runtime.set_device(None)


def both(name, value):
    setattr(jsettings, name, value)
    setattr(tsettings, name, value)


def random_sp(n, density=0.02, dtype=np.float32, seed=0):
    """Random columns defeat band detection: engine-eligible."""
    rng = np.random.default_rng(seed)
    S = sp.random(n, n, density=density, format="csr", random_state=rng,
                  dtype=np.float64)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        S = (S + 1j * sp.random(
            n, n, density=density, format="csr",
            random_state=np.random.default_rng(seed + 1),
            dtype=np.float64)).tocsr()
    return S.astype(dtype)


def pair(S):
    return jsparse.csr_array(S), tsparse.csr_array(S, device="cpu")


def vec(n, dtype=np.float32, seed=1, k=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def np_(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same(a, b):
    return np.array_equal(np_(a), np_(b), equal_nan=True)


def ref_spmv(A, x):
    return tspmv.csr_spmv_rowids(A.data, A.indices, A._get_row_ids(),
                                 torch.as_tensor(x), A.shape[0])


def plan_counts(obs):
    snap = obs.counters.snapshot("engine.")
    return {k: v for k, v in snap.items()
            if k.startswith(("engine.plan.", "engine.exec."))
            and not k.endswith("build_ms") and "queue_ns" not in k}


# ---------------------------------------------------------------- buckets


@pytest.mark.parametrize("value,ladder,minimum", [
    (1000, (), 64), (1024, (), 64), (3, (), 64), (900, (1000, 5000), 1),
    (1000, (1000, 5000), 1), (4000, (1000, 5000), 1),
    (6000, (1000, 5000), 1), (1, (), 1)])
def test_bucket_policy(value, ladder, minimum):
    from legate_sparse_tpu.engine import buckets as jb

    assert bucket(value, ladder, minimum) == jb.bucket(value, ladder,
                                                       minimum)
    assert next_pow2(value) == jb.next_pow2(value)
    assert k_bucket(value % 9) == jb.k_bucket(value % 9)


def test_ladder_setting_applies():
    from legate_sparse_tpu.engine import buckets as jb

    both("engine_bucket_ladder", (500, 2000))
    both("engine_min_bucket", 1)
    for v in (400, 1999, 2001):
        assert bucket(v) == jb.bucket(v)
    assert bucket(400) == 500 and bucket(1999) == 2000


# ---------------------------------------------------- bucketed correctness


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_bucketed_spmv_bitident_fuzz(dtype):
    """Bucketed SpMV == unpadded csr-rowids bit for bit, across sizes
    including the bucket boundary, and == the JAX engine's."""
    eng, jeng = Engine(), JEngine()
    for n, seed in [(100, 0), (256, 1), (300, 2), (511, 3)]:
        J, T = pair(random_sp(n, dtype=dtype, seed=seed))
        x = vec(n, dtype, seed=seed + 10)
        y = eng.matvec(T, x)
        assert y is not None and tuple(y.shape) == (n,)
        assert same(y, ref_spmv(T, x)), (dtype, n)
        yj = np_(jeng.matvec(J, x))
        if dtype == np.complex64:
            np.testing.assert_allclose(np_(y), yj, rtol=1e-6, atol=1e-6)
        else:
            assert same(y, yj), (dtype, n)


def test_bucketed_spmv_boundary_exact_nnz():
    """n = 256 = rows_b and nnz = 4096 = nnz_b: no padding anywhere."""
    n, per_row = 256, 16
    rng = np.random.default_rng(5)
    indptr = np.arange(n + 1, dtype=np.int64) * per_row
    indices = rng.integers(0, n, size=n * per_row).astype(np.int32)
    row_ids = np.repeat(np.arange(n), per_row)
    order = np.lexsort((indices, row_ids))
    data = rng.standard_normal(n * per_row).astype(np.float32)
    S = sp.csr_matrix((data, indices[order], indptr), shape=(n, n))
    J, T = pair(S)
    assert T.nnz == 4096
    x = vec(n)
    y = Engine().matvec(T, x)
    assert same(y, ref_spmv(T, x))
    assert same(y, JEngine().matvec(J, x))


def test_bucketed_spmv_nonfinite_x_masked_tail():
    """Padded slots contribute an exact zero against inf/nan x."""
    n = 200
    J, T = pair(random_sp(n, seed=4))
    x = vec(n)
    x[7], x[11] = np.inf, np.nan
    y = Engine().matvec(T, x)
    assert same(y, ref_spmv(T, x))
    assert same(y, JEngine().matvec(J, x))


def test_negative_zero_row_sums():
    """Against x = -0.0 every product is -0.0: the rows' sums (and their
    sign bits) are the unpadded product's and the JAX engine's."""
    J, T = pair(random_sp(200, seed=9))
    x = np.full(200, -0.0, np.float32)
    y = Engine().matvec(T, x)
    ref = ref_spmv(T, x)
    assert same(y, ref) and same(y, JEngine().matvec(J, x))
    assert np.array_equal(np.signbit(np_(y)), np.signbit(np_(ref)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_bucketed_spmm_bitident(dtype):
    n, k = 220, 3            # k buckets to 4: one padded column
    J, T = pair(random_sp(n, dtype=dtype, seed=6))
    X = vec(n, dtype, seed=6, k=k)
    Y = Engine().matmat(T, X)
    assert Y is not None and tuple(Y.shape) == (n, k)
    assert same(Y, tspmv.csr_spmm_rowids(T.data, T.indices,
                                         T._get_row_ids(),
                                         torch.as_tensor(X), n))
    for j in range(k):        # each column is its SpMV, bit for bit
        assert same(Y[:, j], ref_spmv(T, np.ascontiguousarray(X[:, j])))
    Yj = np_(JEngine().matmat(J, X))
    if dtype == np.complex64:
        np.testing.assert_allclose(np_(Y), Yj, rtol=1e-6, atol=1e-6)
    else:
        assert same(Y, Yj)


def test_multi_matvec_bitident():
    """One stacked dispatch of matrices from one bucket (batch padded
    3 -> 4): each result bit for bit its own plan's and the JAX
    package's."""
    eng, jeng = Engine(), JEngine()
    mats = [pair(random_sp(400, density=0.03, seed=s)) for s in (3, 4, 5)]
    xs = [vec(400, seed=20 + i) for i in range(3)]
    ys = eng.multi_matvec([(T, x) for (_, T), x in zip(mats, xs)])
    yjs = jeng.multi_matvec([(J, x) for (J, _), x in zip(mats, xs)])
    for y, yj, (_, T), x in zip(ys, yjs, mats, xs):
        assert same(y, eng.matvec(T, x))
        assert same(y, yj)
    with pytest.raises(ValueError, match="different shape buckets"):
        eng.multi_matvec([(mats[0][1], xs[0]),
                          (tsparse.csr_array(random_sp(90, seed=1),
                                             device="cpu"), vec(90))])


def test_multi_matvec_plain_counts_lengths():
    """The stacked product without the pack's lengths (counted from the
    row ids) equals the one with them."""
    eng = Engine()
    _, T = pair(random_sp(120, seed=8))
    key = eng._key("spmv_multi", 120, 120, T.nnz, T.dtype, k=2)
    p = eng._pack_for(T, key)
    rid = torch.cat([T._get_row_ids().to(torch.int64),
                     torch.full((key.nnz_b - T.nnz,), key.rows_b)])
    X = torch.as_tensor(np.stack([vec(key.cols_b, seed=s)
                                  for s in (1, 2)]))
    args = (torch.stack([p.data] * 2), torch.stack([p.indices] * 2))
    valid = torch.stack([p.valid, p.valid])
    with_l = tspmv.csr_multi_spmv_rowids_masked(
        *args, None, valid, X, key.rows_b, 2,
        lengths=torch.stack([p.lengths] * 2))
    without = tspmv.csr_multi_spmv_rowids_masked(
        *args, torch.stack([rid] * 2), valid, X, key.rows_b, 2)
    assert same(with_l, without)


# -------------------------------------------------------------- plan cache


def _plan_sequence(Eng, make, x_of):
    """One call sequence: two matrices of one bucket, a warmed spec, an
    SpMM, a multi dispatch, and an eviction under capacity 2."""
    eng = Eng(plan_capacity=2)
    A1, A2, A3 = make(1000, 11), make(1010, 12), make(90, 14)
    eng.matvec(A1, x_of(1000))
    eng.matvec(A2, x_of(1010))
    eng.matvec(A1, x_of(1000))
    eng.warmup([{"op": "spmv", "dtype": "float32", "rows": 700,
                 "nnz": 9000}])
    eng.matmat(A1, np.stack([x_of(1000)] * 3, axis=1))
    eng.multi_matvec([(A1, x_of(1000)), (A2, x_of(1010))])
    eng.matvec(A3, x_of(90))
    eng.matvec(A1, x_of(1000))


def test_plan_counts_equal_jax():
    """``engine.plan.*`` hits, misses, evictions, builds and execs, per
    plan and in all, equal the JAX package's over the same calls."""
    _plan_sequence(JEngine, lambda n, s: jsparse.csr_array(
        random_sp(n, seed=s)), lambda n: vec(n))
    _plan_sequence(Engine, lambda n, s: tsparse.csr_array(
        random_sp(n, seed=s), device="cpu"), lambda n: vec(n))
    tc, jc = plan_counts(tobs), plan_counts(jobs)
    assert tc == jc
    assert tc["engine.plan.evictions"] >= 1 and tc["engine.plan.hits"] >= 2


def test_settings_epoch_invalidates():
    eng = Engine()
    _, T = pair(random_sp(90, seed=14))
    x = vec(90)
    assert eng.matvec(T, x) is not None
    miss0 = tobs.counters.get("engine.plan.misses")
    ep0 = tsettings.epoch
    tsettings.ell_max_expand = tsettings.ell_max_expand
    tsettings.obs = tsettings.obs
    tsettings.engine_max_batch = 3
    assert tsettings.epoch == ep0
    assert eng.matvec(T, x) is not None
    assert tobs.counters.get("engine.plan.misses") == miss0
    tsettings.ell_max_expand = tsettings.ell_max_expand + 1.0
    assert tsettings.epoch == ep0 + 1
    assert eng.matvec(T, x) is not None
    assert tobs.counters.get("engine.plan.misses") == miss0 + 1
    tsettings.engine_max_batch = 8


def test_epoch_exempt_names_match_jax():
    """Every setting the port shares with the JAX package is exempt
    from the epoch in both or in neither."""
    shared = {k for k in vars(tsettings) if hasattr(jsettings, k)}
    for k in shared:
        assert ((k in type(tsettings)._EPOCH_EXEMPT)
                == (k in type(jsettings)._EPOCH_EXEMPT)), k


def test_no_persistent_compile_cache():
    """Eager plans compile nothing: the JAX package's persistent-cache
    setting and hook have no counterpart."""
    assert hasattr(jsettings, "engine_persist_dir")
    assert not hasattr(tsettings, "engine_persist_dir")
    assert not hasattr(tsparse.engine, "maybe_enable_persistent_cache")
    plan = Engine().plan_for("spmv", 100, 100, 500, torch.float32)
    assert callable(plan.fn) and plan.meta["kernel"] == "csr_spmv_rowids"


def test_plan_lru_eviction():
    eng = Engine(plan_capacity=1)
    _, T1 = pair(random_sp(80, seed=15))
    _, T2 = pair(random_sp(600, seed=16))
    eng.matvec(T1, vec(80))
    eng.matvec(T2, vec(600))
    assert tobs.counters.get("engine.plan.evictions") == 1


def test_pack_invalidation_on_data_mutation():
    eng = Engine()
    _, T = pair(random_sp(150, seed=17))
    x = vec(150)
    y1 = eng.matvec(T, x)
    pack = T._engine_pack[1]
    T.data = T.data * 2.0          # the setter invalidates the caches
    assert T._engine_pack is None
    y2 = eng.matvec(T, x)
    assert T._engine_pack[1] is not pack
    assert same(y2, ref_spmv(T, x))
    np.testing.assert_allclose(np_(y2), 2 * np_(y1), rtol=1e-6, atol=1e-6)


def test_engine_declines_banded_and_block():
    """DIA and BSR matrices decline (they keep their kernels), as do
    promoted operands."""
    eng = Engine()
    n = 256
    S = sp.diags([np.ones(n - 1), np.full(n, 2.0), np.ones(n - 1)],
                 [-1, 0, 1], format="csr", dtype=np.float32)
    J, T = pair(S)
    assert T._get_dia() is not None
    assert eng.matvec(T, vec(n)) is None
    assert JEngine().matvec(J, vec(n)) is None
    _, R = pair(random_sp(300, seed=18))
    assert eng.matvec(R, vec(300, np.float64)) is None   # promotion
    Ti = tsparse.csr_array((random_sp(300, seed=18) * 8).astype(np.int32),
                           device="cpu")
    assert eng.matvec(Ti, np.ones(300, np.int32)) is None  # integers
    saved = tsettings.bsr_force
    try:
        tsettings.bsr_force = True
        rng = np.random.default_rng(3)
        B = sp.random(256, 256, density=0.3, random_state=rng,
                      format="csr", dtype=np.float32)
        Tb = tsparse.csr_array(B, device="cpu")
        assert Tb._get_dia() is None and Tb._get_bsr() is not None
        assert eng.matvec(Tb, vec(256)) is None
    finally:
        tsettings.bsr_force = saved


def test_matvec_shape_validation():
    eng = Engine()
    _, T = pair(random_sp(64, seed=19))
    with pytest.raises(ValueError):
        eng.matvec(T, vec(65))
    with pytest.raises(ValueError):
        eng.matmat(T, np.ones((63, 2), np.float32))


def test_failed_plan_build_negative_cache(monkeypatch):
    """A failed build is cached: the second routed dispatch fails fast
    and still falls back to the plain dispatch; an executor batch whose
    plan cannot build resolves through the plain dispatch."""
    calls = {"n": 0}

    def bad_builder(key):
        calls["n"] += 1
        raise RuntimeError("synthetic build failure")

    monkeypatch.setitem(plan_cache.BUILDERS, "spmv", bad_builder)
    monkeypatch.setitem(plan_cache.BUILDERS, "spmm", bad_builder)
    tsettings.engine = True
    engine_core.reset_engine()
    _, T = pair(random_sp(160, seed=31))
    x = vec(160)
    y1 = T @ x
    y2 = T @ x
    assert calls["n"] == 1
    assert tobs.counters.get("engine.plan.failed_fast") == 1
    assert tobs.counters.get("engine.route.error") == 2
    ex = RequestExecutor(engine_core.get_engine(), max_batch=2,
                         queue_depth=8, timeout_ms=0)
    try:
        f1, f2 = ex.submit(T, x), ex.submit(T, x)
    finally:
        ex.shutdown()
    tsettings.engine = False
    ref = T @ x
    for y in (y1, y2, f1.result(timeout=30), f2.result(timeout=30)):
        assert same(y, ref)
    assert tobs.counters.get("engine.exec.dispatch_fallback") == 1


# ---------------------------------------------------------------- executor


def test_executor_batched_bitident_and_counters():
    """6 requests at max_batch 4: one stacked dispatch of 4 and a flush
    of 2, each column bit for bit its single dispatch; the counters
    equal the JAX executor's over the same submissions."""
    S = random_sp(400, seed=20)
    xs = [vec(400, seed=30 + i) for i in range(6)]
    outs = {}
    for name, Eng, Ex, A in (
            ("jax", JEngine, JExecutor, jsparse.csr_array(S)),
            ("torch", Engine, RequestExecutor,
             tsparse.csr_array(S, device="cpu"))):
        ex = Ex(Eng(), max_batch=4, queue_depth=32, timeout_ms=0)
        try:
            futs = [ex.submit(A, x) for x in xs]
            ex.flush()
            outs[name] = [np_(f.result(timeout=30)) for f in futs]
        finally:
            ex.shutdown()
    T = tsparse.csr_array(S, device="cpu")
    for y, yj, x in zip(outs["torch"], outs["jax"], xs):
        assert same(y, ref_spmv(T, x))
        assert same(y, yj)
    assert plan_counts(tobs) == plan_counts(jobs)
    assert tobs.counters.get("engine.exec.batches") == 2


def test_executor_timeout_worker():
    _, T = pair(random_sp(120, seed=21))
    ex = RequestExecutor(Engine(), max_batch=64, queue_depth=128,
                         timeout_ms=5)
    try:
        futs = [ex.submit(T, vec(120, seed=40 + i)) for i in range(3)]
        for f, i in zip(futs, range(3)):
            assert same(f.result(timeout=30),
                        ref_spmv(T, vec(120, seed=40 + i)))
    finally:
        ex.shutdown()
    assert ex._worker is None or not ex._worker.is_alive()


def test_executor_backpressure_inline_dispatch():
    _, T = pair(random_sp(130, seed=22))
    ex = RequestExecutor(Engine(), max_batch=64, queue_depth=2,
                         timeout_ms=0)
    try:
        futs = [ex.submit(T, vec(130, seed=50 + i)) for i in range(4)]
        assert tobs.counters.get("engine.exec.backpressure") >= 1
        ex.flush()
        for f in futs:
            assert tuple(f.result(timeout=30).shape) == (130,)
    finally:
        ex.shutdown()


def test_executor_backpressure_age_bound_beats_largest_group():
    """With timeout_ms=0 the age bound is 0: the oldest group (a lone
    request for A) wins the eviction pick over the fuller group for B."""
    _, TA = pair(random_sp(140, seed=23))
    _, TB = pair(random_sp(140, seed=24))
    ex = RequestExecutor(Engine(), max_batch=64, queue_depth=4,
                         timeout_ms=0)
    try:
        xa = vec(140, seed=60)
        fut_a = ex.submit(TA, xa)
        futs_b = [ex.submit(TB, vec(140, seed=61 + i)) for i in range(3)]
        trigger = ex.submit(TB, vec(140, seed=70))
        assert fut_a.done()
        assert not any(f.done() for f in futs_b)
        assert tobs.counters.get("engine.exec.backpressure_aged") == 1
        assert same(fut_a.result(timeout=30), ref_spmv(TA, xa))
        ex.flush()
        for f in futs_b + [trigger]:
            assert tuple(f.result(timeout=30).shape) == (140,)
    finally:
        ex.shutdown()


def test_executor_rejects_bad_shape_and_shutdown_submits():
    _, T = pair(random_sp(110, seed=27))
    ex = RequestExecutor(Engine(), max_batch=4, queue_depth=8, timeout_ms=0)
    try:
        good = ex.submit(T, vec(110))
        with pytest.raises(ValueError):
            ex.submit(T, vec(111))
        with pytest.raises(ValueError):
            ex.submit(T, [1.0] * 111)
        ex.flush()
        assert tuple(good.result(timeout=30).shape) == (110,)
    finally:
        ex.shutdown()
    with pytest.raises(RuntimeError):
        ex.submit(T, vec(110))


def test_executor_ineligible_inline():
    n = 256
    _, T = pair(sp.diags([np.ones(n - 1), np.full(n, 2.0), np.ones(n - 1)],
                         [-1, 0, 1], format="csr", dtype=np.float32))
    ex = RequestExecutor(Engine(), max_batch=4, queue_depth=8, timeout_ms=0)
    try:
        x = vec(n)
        f = ex.submit(T, x)
        assert tobs.counters.get("engine.exec.inline") == 1
        assert same(f.result(timeout=30), T @ x)
    finally:
        ex.shutdown()


def test_executor_dispatch_failure_resolves_futures(monkeypatch):
    """A failure in the worker's dispatch, and in the fallback too,
    resolves every future with the error; the worker keeps serving."""
    _, T = pair(random_sp(100, seed=33))
    eng = Engine()
    ex = RequestExecutor(eng, max_batch=64, queue_depth=64, timeout_ms=2)
    try:
        def boom(*a, **k):
            raise RuntimeError("synthetic dispatch failure")

        monkeypatch.setattr(eng, "matvec", boom)
        monkeypatch.setattr(eng, "matmat", boom)
        monkeypatch.setattr(type(T), "dot", boom)
        futs = [ex.submit(T, vec(100, seed=i)) for i in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="synthetic"):
                f.result(timeout=30)
        monkeypatch.undo()
        f = ex.submit(T, vec(100, seed=5))
        assert same(f.result(timeout=30), ref_spmv(T, vec(100, seed=5)))
    finally:
        ex.shutdown()


def test_executor_thread_safety():
    import sys

    _, T = pair(random_sp(200, seed=23))
    ex = RequestExecutor(Engine(), max_batch=8, queue_depth=64,
                         timeout_ms=50)
    xs = [vec(200, seed=60 + i) for i in range(16)]
    futs = [None] * len(xs)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submit(lo, hi):
            for i in range(lo, hi):
                futs[i] = ex.submit(T, xs[i])

        threads = [threading.Thread(target=submit, args=(i * 4, i * 4 + 4))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        ex.flush()
        for f, x in zip(futs, xs):
            assert same(f.result(timeout=30), ref_spmv(T, x))
    finally:
        sys.setswitchinterval(old)
        ex.shutdown()
    assert tobs.counters.get("engine.exec.submitted") == 16


# ---------------------------------------------------------------- routing


def _spd(n, seed, dtype=np.float64):
    S = sp.random(n, n, density=0.02, format="csr",
                  random_state=np.random.default_rng(seed), dtype=dtype)
    return (S + S.T + sp.eye(n, dtype=dtype) * 10).tocsr()


def test_engine_routed_cg_bitident():
    """CG with the engine on is bit for bit CG with it off (the solver's
    closure is the bucketed plan), and within 1e-10 of the JAX
    package's engine-routed CG (f64), in the same iterations."""
    both("ell_max_expand", 0.0)
    both("dia_max_expand", 0.0)
    S = _spd(300, 8)
    b = np.ones(300)
    tsettings.engine = True
    x_eng, it_eng = tlinalg.cg(tsparse.csr_array(S, device="cpu"), b,
                               maxiter=40)
    assert tobs.counters.snapshot("engine.plan.")
    tsettings.engine = False
    x_ref, it_ref = tlinalg.cg(tsparse.csr_array(S, device="cpu"), b,
                               maxiter=40)
    assert int(it_eng) == int(it_ref)
    assert same(x_eng, x_ref)
    jsettings.engine = True
    xj, itj = jlinalg.cg(jsparse.csr_array(S), b, maxiter=40)
    jsettings.engine = False
    assert int(itj) == int(it_eng)
    np.testing.assert_allclose(np_(x_eng), np_(xj), rtol=1e-10,
                               atol=1e-10)


def test_solver_route_not_stale_after_mutation():
    both("ell_max_expand", 0.0)
    both("dia_max_expand", 0.0)
    S = _spd(220, 30, np.float32)
    b = np.ones(220, np.float32)
    tsettings.engine = True
    T = tsparse.csr_array(S, device="cpu")
    op = tlinalg.make_linear_operator(T)
    assert op._engine_mv is not None and op._engine_fresh()
    T.data = T.data * 1.5
    assert not op._engine_fresh()
    x_eng, it_eng = tlinalg.cg(op, b, maxiter=60)
    tsettings.engine = False
    R = tsparse.csr_array(S, device="cpu")
    R.data = R.data * 1.5
    x_ref, it_ref = tlinalg.cg(R, b, maxiter=60)
    assert int(it_eng) == int(it_ref)
    assert same(x_eng, x_ref)


def test_promoted_rhs_solve_not_downcast():
    S = _spd(200, 29, np.float32)
    b = np.ones(200, np.float64)
    tsettings.engine = True
    x_eng, it_eng = tlinalg.cg(tsparse.csr_array(S, device="cpu"), b,
                               maxiter=60)
    tsettings.engine = False
    x_ref, it_ref = tlinalg.cg(tsparse.csr_array(S, device="cpu"), b,
                               maxiter=60)
    assert x_eng.dtype == torch.float64
    assert int(it_eng) == int(it_ref)
    assert same(x_eng, x_ref)


def test_route_falls_back_on_engine_error(monkeypatch):
    """'settings.engine = True is always safe': an engine failure in
    routing is counted and the plain dispatch serves."""
    tsettings.engine = True
    _, T = pair(random_sp(140, seed=28))
    x = vec(140)

    def boom(self, A, x, _checked=False):
        raise RuntimeError("synthetic plan build failure")

    monkeypatch.setattr(engine_core.Engine, "matvec", boom)
    y = T @ x
    assert tobs.counters.get("engine.route.error") == 1
    assert T.spmv_path != "engine"
    tsettings.engine = False
    assert same(y, T @ x)


def test_solver_falls_back_on_engine_error(monkeypatch):
    from legate_sparse_tpu_torch.engine.plan_cache import PlanBuildError

    tsettings.engine = True
    S = _spd(120, 3)
    T = tsparse.csr_array(S, device="cpu")
    b = vec(120, np.float64)

    def boom(self, A):
        raise PlanBuildError("synthetic cached failure")

    monkeypatch.setattr(engine_core.Engine, "traceable_matvec", boom)
    x, _ = tlinalg.cg(T, b, rtol=1e-8, maxiter=300)
    assert tobs.counters.get("engine.route.error") == 1
    np.testing.assert_allclose(S @ np_(x), b, atol=1e-6)


def test_dot_routes_through_engine():
    tsettings.engine = True
    _, T = pair(random_sp(350, seed=24))
    x = vec(350)
    tobs.enable()
    try:
        y = T @ x
        assert T.spmv_path == "engine"
        spans = [r for r in tobs.records()
                 if r.get("type") == "span" and r["name"] == "spmv"]
        assert spans and spans[-1]["attrs"]["path"] == "engine"
        Y = T @ np.stack([x] * 2, axis=1)
        assert T.spmm_path == "engine"
    finally:
        tobs.disable()
    assert same(y, ref_spmv(T, x))
    assert same(Y[:, 1], y)


def test_engine_off_is_inert():
    _, T = pair(random_sp(360, seed=25))
    _ = T @ vec(360)
    assert not tobs.counters.snapshot("engine.")
    assert T.spmv_path != "engine"


# ------------------------------------------------------------- distributed


def test_dist_plan_ledger_counts_equal_jax():
    """At 8 gloo ranks the distributed plan ledger counts as the JAX
    package's does on its 8-device mesh: one miss, then a hit."""
    from legate_sparse_tpu.parallel import make_row_mesh, shard_csr
    from legate_sparse_tpu.parallel.dist_csr import shard_vector

    from legate_sparse_tpu_torch.parallel.launch import run_ranks
    from test_torch_gpu import engine_dist_ledger_rank

    n = 1 << 10
    rng1 = np.random.default_rng(1)
    A1 = jsparse.csr_array(sp.diags(
        [rng1.standard_normal(n - 1).astype(np.float32),
         np.full(n, 4.0, np.float32),
         rng1.standard_normal(n - 1).astype(np.float32)],
        [-1, 0, 1], format="csr", dtype=np.float32))
    rng2 = np.random.default_rng(2)
    A2 = jsparse.csr_array(sp.diags(
        [rng2.standard_normal(n - 1).astype(np.float32),
         np.full(n, 4.0, np.float32),
         rng2.standard_normal(n - 1).astype(np.float32)],
        [-1, 0, 1], format="csr", dtype=np.float32))
    mesh = make_row_mesh()
    dA1, dA2 = shard_csr(A1, mesh=mesh), shard_csr(A2, mesh=mesh)
    x = shard_vector(np.ones(n, np.float32), mesh, dA1.rows_padded)
    eng = JEngine()
    m0 = jobs.counters.get("engine.plan.misses")
    h0 = jobs.counters.get("engine.plan.hits")
    yj = np.asarray(eng.dist_matvec(dA1, x))[:n]
    eng.dist_matvec(dA2, x)
    jm = jobs.counters.get("engine.plan.misses") - m0
    jh = jobs.counters.get("engine.plan.hits") - h0
    results = run_ranks(engine_dist_ledger_rank, 8, backend="gloo", timeout=300)
    for r in results:
        assert (r["misses"], r["hits"]) == (jm, jh) == (1, 1)
        assert r["miss_after_first"] == 1
        np.testing.assert_allclose(r["y"], yj, rtol=1e-6, atol=1e-6)
