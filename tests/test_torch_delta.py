# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's delta layer (``legate_sparse_tpu_torch.delta``) and
``gallery.mutation_stream`` against the JAX package's
(``tests/test_delta.py``).

``DeltaCSR`` and the stream run in the pytest process on both
packages, the port on the CPU: the flag gate, overwrite-wins updates,
deletes and validation, the typed capacity error that changes nothing,
the empty buffer bit for bit with the base, the two-term product
against the mutated matrix (1e-13 of ``|A'| |x|`` in f64) and against
the JAX package's, the power-of-two buckets of the device image,
compaction bit for bit with a cold rebuild and with the JAX package's
compacted base, pinned views, the watermark worker (and a failure in it
surfacing at the next call), and ``mutation_stream`` bit for bit with
the JAX generator.

``DistDeltaCSR``, ``reshard``'s carry and the evolving-graph runs need
a process group: one spawn of 8 gloo ranks runs them after the JAX side
has run its counterparts, ``DistDeltaCSR`` on its 8-device CPU mesh and
the graph algorithms on one device of it (as ``test_torch_graph.py``
runs them).  This module imports no
JAX at its top: the ranks import it to find their function.

Not ported here: the retrace-count test (``test_delta.py:264``: the
port compiles nothing); the checkpoint, fault-injection and chaos tests
are in ``test_torch_chaos.py``, the gateway one in
``test_torch_gateway.py``; the report and doctor tests wait for the
port's operations layer.
"""

import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

WORLD = 8
RANK_TIMEOUT = 240.0
_DELTA_KNOBS = ("delta", "delta_capacity", "delta_watermark",
                "delta_worker_ms")


def tridiag(n, dtype=np.float64):
    return sp.diags([np.full(n, 4.0), np.full(n - 1, -1.0),
                     np.full(n - 1, -1.0)], [0, 1, -1], format="csr",
                    dtype=dtype)


def xvec(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


def cold_triples(S, targets):
    """The mutated matrix's sorted (rows, cols, vals): ``S`` with
    ``targets`` applied (0.0 deletes), by a host dict — the independent
    reference of every compaction."""
    S = sp.coo_matrix(S)
    merged = {(int(r), int(c)): v for r, c, v in zip(S.row, S.col, S.data)}
    for (r, c), v in targets.items():
        if v == 0.0:
            merged.pop((r, c), None)
        else:
            merged[(r, c)] = v
    keys = sorted(merged)
    return (np.asarray([k[0] for k in keys], dtype=np.int64),
            np.asarray([k[1] for k in keys], dtype=np.int64),
            np.asarray([merged[k] for k in keys], dtype=S.dtype))


def cold_rebuild(S, targets):
    """The port's COO constructor of the mutated matrix, on the CPU."""
    import legate_sparse_tpu_torch as tsparse

    r, c, v = cold_triples(S, targets)
    return tsparse.csr_array((v, (r, c)), shape=S.shape, device="cpu")


def cold_scipy(S, targets):
    r, c, v = cold_triples(S, targets)
    return sp.csr_matrix((v, (r, c)), shape=S.shape)


def _same_csr(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _parts(A):
    return tuple(np.asarray(t) for t in (A.indptr, A.indices, A.data))


@pytest.fixture
def delta_on():
    """The delta layer on in both packages, their obs state reset."""
    from legate_sparse_tpu import obs as jobs
    from legate_sparse_tpu.settings import settings as jsettings
    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.settings import settings

    saved = [{k: getattr(s, k) for k in _DELTA_KNOBS}
             for s in (settings, jsettings)]
    settings.delta = jsettings.delta = True
    obs.reset_all()
    jobs.reset_all()
    yield settings
    for s, kv in zip((settings, jsettings), saved):
        for k, v in kv.items():
            setattr(s, k, v)
    obs.reset_all()
    jobs.reset_all()


def _pair(S, **kw):
    """(port DeltaCSR on the CPU, JAX DeltaCSR) of one matrix."""
    import legate_sparse_tpu as jsparse
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu.delta import DeltaCSR as JDeltaCSR
    from legate_sparse_tpu_torch.delta import DeltaCSR

    return (DeltaCSR(tsparse.csr_array(S, device="cpu"), **kw),
            JDeltaCSR(jsparse.csr_array(S), **kw))


def _delta_counters():
    from legate_sparse_tpu_torch import obs

    return obs.counters.snapshot("delta.")


# ------------------------------------------------------- flag and buffer --

def test_constructors_require_flag():
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch.delta import DeltaCSR, DistDeltaCSR, route
    from legate_sparse_tpu_torch.settings import settings

    assert not settings.delta, "the suite runs with the delta layer off"
    A = tsparse.csr_array(tridiag(16), device="cpu")
    with pytest.raises(RuntimeError, match="LEGATE_SPARSE_TPU_DELTA"):
        DeltaCSR(A)
    with pytest.raises(RuntimeError, match="LEGATE_SPARSE_TPU_DELTA"):
        DistDeltaCSR(None)
    c0 = _delta_counters()
    A.dot(torch.ones(16, dtype=torch.float64))
    assert route(A) is A, "route passes plain matrices through"
    assert _delta_counters() == c0, "the flag off moves no delta counter"


def test_update_overwrite_wins_and_delete(delta_on):
    from legate_sparse_tpu_torch.delta import is_delta

    D, J = _pair(tridiag(32), capacity=16)
    assert is_delta(D) and not is_delta(D.base)
    for d in (D, J):
        d.update([0, 0], [1, 1], [5.0, 7.0])        # within-batch repeat
        assert d.entries() == {(0, 1): 7.0}
        d.set_entries([0], [1], [9.0])              # cross-batch overwrite
        d.update([3], [3], [0.0])                   # pending delete
        assert d.entries() == {(0, 1): 9.0, (3, 3): 0.0}
        assert d.pending == 2
    assert D._buffer.entries == J._buffer.entries
    c = _delta_counters()
    assert (c["delta.updates"], c["delta.applied"],
            c["delta.overwrites"]) == (3, 2, 2)


def test_update_validation(delta_on):
    D, _ = _pair(tridiag(8))
    with pytest.raises(ValueError, match="shapes disagree"):
        D.update([0, 1], [0], [1.0])
    with pytest.raises(IndexError, match="out of range"):
        D.update([8], [0], [1.0])
    with pytest.raises(IndexError, match="out of range"):
        D.update([0], [-1], [1.0])


def test_capacity_typed_error_mutates_nothing(delta_on):
    from legate_sparse_tpu_torch.delta import DeltaCapacityError

    D, _ = _pair(tridiag(32), capacity=2)
    D.update([0], [0], [1.0])
    view = D.view()
    with pytest.raises(DeltaCapacityError) as ei:
        D.update([1, 2], [1, 2], [1.0, 2.0])
    assert (ei.value.pending, ei.value.capacity) == (3, 2)
    assert D.entries() == {(0, 0): 1.0} and D.pending == 1
    assert D.view() is view, "a failed batch publishes no view"


# ------------------------------------------------------------- serving --

def test_empty_buffer_serves_base_bitwise(delta_on):
    import jax.numpy as jnp

    D, J = _pair(tridiag(96))
    x = xvec(96)
    c0 = _delta_counters()
    y = D.dot(torch.from_numpy(x))
    assert torch.equal(y, D.base.dot(torch.from_numpy(x)))
    np.testing.assert_array_equal(y.numpy(), np.asarray(J.dot(jnp.asarray(x))))
    assert _delta_counters() == c0, "an empty buffer moves no counter"


def test_two_term_serve_matches_mutated_matrix(delta_on):
    import jax.numpy as jnp

    S = tridiag(64)
    D, J = _pair(S)
    targets = {(0, 0): 9.5, (5, 6): -2.25, (63, 62): 0.5, (10, 40): 3.0,
               (10, 41): 1.0, (10, 9): 0.0}
    for (r, c), v in targets.items():
        D.update([r], [c], [v])
        J.update([r], [c], [v])
    x = xvec(64)
    y = D.dot(torch.from_numpy(x)).numpy()
    ref = cold_scipy(S, targets)
    mag = abs(ref) @ np.abs(x)
    assert np.all(np.abs(y - ref @ x) <= 1e-13 * mag)
    np.testing.assert_allclose(y, np.asarray(J.dot(jnp.asarray(x))),
                               rtol=0, atol=1e-13 * mag.max())
    assert _delta_counters()["delta.served"] == 1


def test_pow2_buckets(delta_on):
    """The device image pads to the power-of-two bucket of the pending
    count (at most the capacity), sorted by (row, col), the padding on
    the sentinel row."""
    from legate_sparse_tpu.delta import core as jcore
    from legate_sparse_tpu_torch.delta import core

    for n in (0, 1, 2, 3, 5, 1024, 1025):
        assert core._pow2_bucket(n) == jcore._pow2_bucket(n)
    D, _ = _pair(tridiag(64), capacity=16)
    widths = []
    for k in range(6):
        D.update([9 - k], [k], [float(k + 1)])
        widths.append(int(D.view()._rows_dev.shape[0]))
    assert widths == [1, 2, 4, 4, 8, 8]
    v = D.view()
    assert v._valid == 6
    rows, cols = v._rows_dev.tolist(), v._cols_dev.tolist()
    assert list(zip(rows[:6], cols[:6])) == sorted(zip(rows[:6], cols[:6]))
    assert rows[6:] == [64, 64]


# ------------------------------------------------- compaction, versions --

def test_compact_is_bitwise_cold_rebuild(delta_on):
    """The merged base: bit for bit the COO constructor of the mutated
    matrix and the JAX package's compacted base; served bit for bit
    like the cold rebuild, and within 1e-13 of ``|A'| |x|`` of the JAX
    package's product."""
    import jax.numpy as jnp

    S = tridiag(48)
    D, J = _pair(S)
    targets = {(0, 1): 11.0, (7, 7): 0.0, (20, 3): 1.75, (30, 31): -0.0}
    for (r, c), v in targets.items():
        D.update([r], [c], [v])
        J.update([r], [c], [v])
    assert D.compact() == J.compact() == 4
    ref = cold_rebuild(S, targets)
    _same_csr(_parts(D.base), _parts(ref))
    _same_csr(_parts(D.base), _parts(J.base))
    assert D.base.nnz == S.nnz - 1
    assert (D.pending, D.version) == (0, 1)
    x = xvec(48)
    assert torch.equal(D.dot(torch.from_numpy(x)), ref.dot(torch.from_numpy(x)))
    # The JAX package's routes sum a row in another order.
    mag = abs(cold_scipy(S, targets)) @ np.abs(x)
    assert np.all(np.abs(D.dot(torch.from_numpy(x)).numpy()
                         - np.asarray(J.dot(jnp.asarray(x))))
                  <= 1e-13 * mag)
    c = _delta_counters()
    assert (c["delta.compactions"], c["delta.compaction.merged"],
            c["delta.swap.versions"]) == (1, 4, 1)
    assert c["delta.compaction.bytes"] > 0
    assert D.compact() == 0, "an empty buffer: no compaction"
    assert _delta_counters()["delta.compactions"] == 1


@pytest.mark.parametrize("seed", (3, 17))
def test_compact_stream_bitwise_with_jax(delta_on, seed):
    """A seeded stream of overwrites, inserts and deletes over an f32
    band, compacted: bit for bit with the JAX package's compacted base
    and the cold rebuild."""
    from legate_sparse_tpu_torch import gallery

    S = tridiag(128, np.float32)
    D, J = _pair(S, capacity=256)
    targets = {}
    for rows, cols, vals in gallery.mutation_stream(seed, D.base, 120,
                                                    batch=16):
        D.update(rows, cols, vals)
        J.update(rows, cols, vals)
        targets.update(((int(r), int(c)), float(v))
                       for r, c, v in zip(rows, cols, vals))
    D.compact()
    J.compact()
    _same_csr(_parts(D.base), _parts(J.base))
    _same_csr(_parts(D.base), _parts(cold_rebuild(S, targets)))
    assert D.base.dtype == torch.float32


def test_pinned_view_drains_its_version(delta_on):
    S = tridiag(40)
    D, _ = _pair(S)
    x = torch.from_numpy(xvec(40))
    v0 = D.view()
    y0 = v0.dot(x)
    D.update([0], [0], [123.0])
    v1 = D.view()
    assert v1 is not v0 and v1.pending == 1
    D.compact()
    v2 = D.view()
    assert (v2.version, v2.pending) == (1, 0)
    assert torch.equal(v0.dot(x), y0)
    assert torch.equal(D.dot(x), cold_rebuild(S, {(0, 0): 123.0}).dot(x))


def test_watermark_worker_compacts_in_background(delta_on):
    delta_on.delta_watermark = 0.5
    delta_on.delta_worker_ms = 5.0
    D, _ = _pair(tridiag(32), capacity=8)
    try:
        D.update([0, 1, 2, 3], [0, 1, 2, 3], [1.0, 2.0, 3.0, 4.0])
        deadline = time.monotonic() + 10.0
        while D.pending and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        D.stop_worker()
    assert (D.pending, D.version) == (0, 1)
    assert not D._worker.is_alive()
    c = _delta_counters()
    assert c["delta.watermark.exceeded"] >= 1
    assert c["delta.compactions"] == 1


def test_worker_failure_surfaces(delta_on, monkeypatch):
    """A merge that fails in the worker is logged, counted and raised
    by the next ``update``/``compact``; the buffer is unchanged."""
    from legate_sparse_tpu_torch.delta import core

    delta_on.delta_watermark = 0.5
    delta_on.delta_worker_ms = 5.0
    D, _ = _pair(tridiag(32), capacity=4)
    failed = threading.Event()

    def broken(src, entries):
        failed.set()
        raise MemoryError("no room for the merge")

    monkeypatch.setattr(core, "merged_csr", broken)
    try:
        D.update([0, 1], [0, 1], [1.0, 2.0])
        assert failed.wait(10.0)
        D._worker.join(10.0)
        assert not D._worker.is_alive()
    finally:
        D.stop_worker()
    assert _delta_counters()["delta.worker.errors"] == 1
    with pytest.raises(RuntimeError, match="worker failed") as ei:
        D.update([2], [2], [3.0])
    assert isinstance(ei.value.__cause__, MemoryError)
    assert D.entries() == {(0, 0): 1.0, (1, 1): 2.0} and D.version == 0
    monkeypatch.undo()
    delta_on.delta_worker_ms = 0.0      # no new worker races the compact
    D.update([2], [2], [3.0])
    assert D.compact() == 3


def test_maybe_compact(delta_on):
    D, _ = _pair(tridiag(32), capacity=100)
    D.update([0], [0], [1.0])
    assert D.maybe_compact() == 0 and D.pending == 1
    delta_on.delta_watermark = 0.01
    assert D.maybe_compact() == 1 and D.pending == 0


def test_route_pins_the_current_view(delta_on):
    from legate_sparse_tpu_torch.delta import route

    D, _ = _pair(tridiag(16))
    D.update([0], [0], [2.0])
    v = route(D)
    assert v is D.view()
    assert _delta_counters()["delta.routes"] == 1


# ------------------------------------------------------- mutation_stream --

@pytest.mark.parametrize("seed, kind", [(5, "tridiag"), (6, "tridiag"),
                                        (13, "rmat")])
def test_mutation_stream_bitwise_with_jax(seed, kind):
    """The same seed, pattern and knobs: the JAX generator's stream bit
    for bit (a band, and an R-MAT multigraph's unsorted duplicates), with
    overwrites, inserts and deletes in it."""
    import legate_sparse_tpu as jsparse
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu import gallery as jgallery
    from legate_sparse_tpu_torch import gallery

    if kind == "rmat":
        A = gallery.rmat(6, nnz_per_row=4, rng=78, device="cpu")
        J = jgallery.rmat(6, nnz_per_row=4, rng=78)
    else:
        A = tsparse.csr_array(tridiag(128), device="cpu")
        J = jsparse.csr_array(tridiag(128))
    got = list(gallery.mutation_stream(seed, A, 60, batch=7))
    want = list(jgallery.mutation_stream(seed, J, 60, batch=7))
    assert len(got) == len(want) == 9 and got[-1][0].size == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    pattern = set(zip(*(np.asarray(p).tolist()
                        for p in J._coo_parts()[:2])))
    flat = [(int(r), int(c), float(v)) for rows, cols, vals in got
            for r, c, v in zip(rows, cols, vals)]
    assert any(v == 0.0 for _r, _c, v in flat)
    assert any((r, c) not in pattern for r, c, _v in flat)
    assert any(v != 0.0 and (r, c) in pattern for r, c, v in flat)
    # A scipy matrix goes through its COO triple, as in the JAX package.
    if kind == "tridiag":
        for g, w in zip(gallery.mutation_stream(seed, tridiag(128), 60,
                                                batch=7), want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_mutation_stream_empty_matrix_raises():
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import gallery

    empty = tsparse.csr_array(np.zeros((4, 4)), device="cpu")
    with pytest.raises(ValueError, match="no stored entries"):
        next(gallery.mutation_stream(0, empty, 10))


# ----------------------------------------------------- distributed (ranks) --

DIST_TARGETS = {(0, 0): 2.5, (33, 32): -1.0, (10, 20): 4.0, (63, 1): 0.5}
CARRY_TARGETS = {(5, 5): 9.0, (40, 39): 0.5, (17, 60): 2.0, (62, 62): 0.0}


def evolving_targets(G_parts):
    rows, cols = G_parts
    return {(0, 63): 1.0, (63, 1): 1.0, (int(rows[0]), int(cols[0])): 0.0}


def _ranks(rank, world):
    """The distributed cases on this rank; rank 0's results go back."""
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import gallery, graph, obs
    from legate_sparse_tpu_torch import parallel as P, runtime
    from legate_sparse_tpu_torch.delta import DeltaCSR, DistDeltaCSR
    from legate_sparse_tpu_torch.obs import comm
    from legate_sparse_tpu_torch.parallel import dist_csr as Dc
    from legate_sparse_tpu_torch.settings import settings
    from legate_sparse_tpu_torch.utils import to_numpy

    runtime.set_device("cpu")
    settings.delta = True
    mesh = P.make_row_mesh()
    out = {}
    S = tridiag(64, np.float32)
    A = tsparse.csr_array(S)
    errors = []
    try:
        DistDeltaCSR(A)
    except TypeError as e:
        errors.append(("TypeError", str(e)))
    try:
        DistDeltaCSR(P.dist_poisson2d(8, mesh=mesh, dtype=np.float32))
    except ValueError as e:
        errors.append(("ValueError", str(e)))
    out["errors"] = errors

    # Serve, update, price, compact.
    dA = P.shard_csr(A, mesh=mesh, layout="1d-row")
    D = DistDeltaCSR(dA)
    x = xvec(64, seed=3).astype(np.float32)
    xs = Dc.shard_vector(torch.from_numpy(x), mesh, dA.rows_padded)
    out["empty"] = (D.dot(xs).full_tensor().numpy(),
                    P.dist_spmv(dA, xs).full_tensor().numpy())
    obs.reset_all()
    rows, cols, vals = map(np.asarray, zip(*[(r, c, v) for (r, c), v in
                                             DIST_TARGETS.items()]))
    D.update(rows, cols, vals)
    c_update = obs.counters.snapshot("comm.delta.")
    y = D.dot(xs).full_tensor().numpy()
    out["served"] = (y, obs.counters.snapshot("comm."),
                     comm.all_gather_bytes(dA.rows_per_shard, 4, world),
                     c_update, D._image[3])
    out["compact"] = D.compact()
    out["after"] = (D.version, D.pending,
                    D.base.to_csr().toscipy(),
                    P.dist_spmv(D.base, xs).full_tensor().numpy())
    cold = cold_rebuild(S, DIST_TARGETS)
    out["cold"] = P.dist_spmv(P.shard_csr(cold, mesh=mesh), xs
                              ).full_tensor().numpy()

    # The reshard carry: 1d-row -> 2d-block -> 1d-row, updates pending.
    D = DistDeltaCSR(P.shard_csr(A, mesh=mesh))
    for (r, c), v in CARRY_TARGETS.items():
        D.update([r], [c], [v])
    assert P.reshard(D, mesh=mesh, layout="1d-row") is D
    carry = []
    x9 = torch.from_numpy(xvec(64, seed=9).astype(np.float32))
    for lay in ("2d-block", "1d-row"):
        D = P.reshard(D, layout=lay)
        xv = Dc.shard_vector(x9, D.mesh, D.rows_padded, layout=D.layout)
        carry.append((type(D).__name__, D.layout, D.pending, D.entries(),
                      D.version, D.dot(xv).full_tensor().numpy()))
    out["carry"] = carry

    # Evolving graphs: mutate, compact, rerun.
    G = gallery.rmat(6, nnz_per_row=4, rng=77, device="cpu")
    targets = evolving_targets(tuple(to_numpy(t)[:1]
                                     for t in G._coo_parts()[:2]))
    Dg = DeltaCSR(G)
    for (r, c), v in targets.items():
        Dg.update([r], [c], [v])
    Dg.compact()
    Gs = G.toscipy()
    out["bfs"] = (graph.bfs(Dg.base, source=0).numpy(),
                  graph.bfs(cold_rebuild(Gs, targets), source=0).numpy())
    G2 = gallery.rmat(6, nnz_per_row=4, rng=78, device="cpu")
    Dp = DeltaCSR(G2)
    targets = {}
    for rows, cols, vals in gallery.mutation_stream(13, G2, 30, batch=10):
        Dp.update(rows, cols, vals)
        targets.update(((int(r), int(c)), float(v))
                       for r, c, v in zip(rows, cols, vals))
    Dp.compact()
    out["pagerank"] = (
        graph.pagerank(Dp.base, tol=1e-10, max_iters=60).numpy(),
        graph.pagerank(cold_rebuild(G2.toscipy(), targets), tol=1e-10,
                       max_iters=60).numpy())
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def port(jax_side):
    """Rank 0's results of the 8-rank launch, started once the JAX side
    is done: the JAX package's CPU client has aborted in an eager
    8-device op with eight ranks starting beside it under the suite's
    parallel workers, so the two do not overlap here."""
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_ranks, WORLD, backend="gloo", timeout=RANK_TIMEOUT,
                     threads=1)[0]


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    import legate_sparse_tpu as jsparse
    from legate_sparse_tpu import gallery, graph
    from legate_sparse_tpu.delta import DeltaCSR, DistDeltaCSR
    from legate_sparse_tpu.parallel import make_row_mesh, shard_csr
    from legate_sparse_tpu.parallel.dist_csr import dist_spmv, shard_vector
    from legate_sparse_tpu.settings import settings

    devs = jax.devices("cpu")
    if len(devs) < WORLD:
        pytest.skip("needs 8 virtual devices")
    saved = settings.delta
    settings.delta = True
    try:
        mesh = make_row_mesh(devs[:WORLD])
        one = make_row_mesh(devs[:1])
        out = {}
        A = jsparse.csr_array(tridiag(64, np.float32))
        D = DistDeltaCSR(shard_csr(A, mesh=mesh, layout="1d-row"))
        x = xvec(64, seed=3).astype(np.float32)
        xs = shard_vector(jnp.asarray(x), mesh, D.rows_padded,
                          layout="1d-row")
        for (r, c), v in DIST_TARGETS.items():
            D.update([r], [c], [v])
        out["served"] = np.asarray(D.dot(xs))
        D.compact()
        out["after"] = (D.base.to_csr().toscipy(),
                        np.asarray(dist_spmv(D.base, xs)))
        G = gallery.rmat(6, nnz_per_row=4, rng=77)
        targets = evolving_targets(tuple(np.asarray(t)[:1]
                                         for t in G._coo_parts()[:2]))
        Dg = DeltaCSR(G)
        for (r, c), v in targets.items():
            Dg.update([r], [c], [v])
        Dg.compact()
        out["bfs"] = np.asarray(graph.bfs(Dg.base, source=0, mesh=one))
        G2 = gallery.rmat(6, nnz_per_row=4, rng=78)
        Dp = DeltaCSR(G2)
        for rows, cols, vals in gallery.mutation_stream(13, G2, 30,
                                                        batch=10):
            Dp.update(rows, cols, vals)
        Dp.compact()
        out["pagerank"] = np.asarray(graph.pagerank(Dp.base, tol=1e-10,
                                                    max_iters=60, mesh=one))
    finally:
        settings.delta = saved
    return out


def test_dist_delta_typed_errors(port):
    kinds = [k for k, _ in port["errors"]]
    assert kinds == ["TypeError", "ValueError"]
    assert "wraps a DistCSR" in port["errors"][0][1]
    assert "_src_csr" in port["errors"][1][1]


def test_dist_delta_serve_pricing_and_compact(port, jax_side):
    """An empty buffer is ``dist_spmv`` bit for bit; the two-term
    product is the mutated matrix's (1e-6 of ``|A'| |x|``) and the JAX
    package's; the updates send nothing (every rank holds the batch:
    no ``comm.delta.scatter``, where the JAX package prices one), each
    served product all-gathers x once; compaction rebuilds the base bit
    for bit with the cold rebuild's ``shard_csr`` and the JAX package's
    compacted base."""
    y0, y_base = port["empty"]
    np.testing.assert_array_equal(y0, y_base)
    y, snap, gather_bytes, c_update, valid = port["served"]
    S = tridiag(64, np.float32)
    x = xvec(64, seed=3).astype(np.float32)
    ref = cold_scipy(S.astype(np.float64), DIST_TARGETS)
    mag = abs(ref) @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(y[:64] - ref @ x) <= 1e-6 * mag)
    np.testing.assert_allclose(y[:64], jax_side["served"][:64], rtol=0,
                               atol=1e-6 * mag.max())
    assert c_update == {}
    assert snap["comm.delta.all_gather"] == 1
    assert snap["comm.delta.all_gather_bytes"] == gather_bytes > 0
    assert not any(k.startswith("comm.delta.scatter") for k in snap)
    assert 1 <= valid <= len(DIST_TARGETS)
    assert port["compact"] == len(DIST_TARGETS)
    version, pending, base_sp, y_after = port["after"]
    assert (version, pending) == (1, 0)
    j_sp, j_after = jax_side["after"]
    _same_csr((base_sp.indptr, base_sp.indices, base_sp.data),
              (j_sp.indptr, j_sp.indices, j_sp.data))
    r, c, v = cold_triples(S, DIST_TARGETS)
    cold_sp = sp.csr_matrix((v, (r, c)), shape=S.shape)
    _same_csr((base_sp.indptr, base_sp.indices, base_sp.data),
              (cold_sp.indptr, cold_sp.indices, cold_sp.data))
    np.testing.assert_array_equal(y_after, port["cold"])
    np.testing.assert_allclose(y_after[:64], j_after[:64], rtol=0,
                               atol=1e-6 * mag.max())


def test_reshard_carries_pending_buffer(port):
    """``reshard`` of a wrapper with pending updates, 1d-row ->
    2d-block -> 1d-row at 8 ranks: the buffer, its entries and the
    version survive, and every layout serves the mutated matrix."""
    S = tridiag(64, np.float32).astype(np.float64)
    x = xvec(64, seed=9).astype(np.float32).astype(np.float64)
    ref = cold_scipy(S, CARRY_TARGETS)
    mag = abs(ref) @ np.abs(x)
    for (kind, layout, pending, entries, version, y), want in zip(
            port["carry"], ("2d-block", "1d-row")):
        assert (kind, layout) == ("DistDeltaCSR", want)
        assert pending == len(CARRY_TARGETS) and entries == CARRY_TARGETS
        assert version == 0
        assert np.all(np.abs(y[:64] - ref @ x) <= 1e-6 * mag)


def test_evolving_graph_bfs_bitwise(port, jax_side):
    """Mutate edges through the delta layer, compact, rerun BFS: the
    levels are the cold rebuild's and the JAX package's, bit for bit,
    and the inserted 0 -> 63 edge is taken."""
    got, cold = port["bfs"]
    np.testing.assert_array_equal(got, cold)
    np.testing.assert_array_equal(got, jax_side["bfs"])
    assert int(got[63]) == 1


def test_evolving_graph_pagerank(port, jax_side):
    got, cold = port["pagerank"]
    np.testing.assert_allclose(got, cold, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got, jax_side["pagerank"], rtol=1e-7,
                               atol=1e-9)
