# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's graph layer (``legate_sparse_tpu_torch.graph`` and the
semiring arm of ``parallel.dist_spmv``/``dist_spmm``) against the JAX
package's (``tests/test_graph.py``).

The catalog and the single-device ``graph.matvec`` run in the pytest
process on both packages.  Everything distributed runs in one spawn of
8 gloo ranks (``parallel.launch.run_ranks``) after the JAX side has run
the same cases, the semiring products on its 8-device CPU mesh and the
algorithms on one device of it: their results do not depend on the
mesh, and a traversal dispatches hundreds of eager multi-device
programs, which XLA's CPU client has aborted under the CPU load of the
suite's parallel workers (the JAX package's own ``test_graph.py``
PageRank cases abort that way beside busy processes).  The ranks send
rank 0's numpy results back.  This module imports no JAX at its top: the ranks import
it to find their function.

- The semiring ``dist_spmv`` in each layout and realization (1d-row
  halo, all-gather, precise and padded CSR; 1d-col; 2d-block on 2x4)
  for min-plus, max-times and or-and: bit for bit with the JAX
  package's and with a dense reference, the route label equal, the
  ``op.*``/``comm.*``/``graph.*`` counters of one call equal to the JAX
  package's and to ``semiring_spmv_comm_volumes``; the semiring
  ``dist_spmm`` (1d-row) bit for bit likewise.
- BFS, SSSP and connected components on 1d-row and 2d-block: bit for
  bit with the JAX package's (integers; min-plus sums along one path,
  in one order) and held to scipy; PageRank within 1e-12 (relative) of
  the JAX package's (its sums meet in another order) and 1e-8 of a
  dense power iteration; batched sources against per-source runs bit
  for bit; a multigraph's PageRank mass; the BFS comm counters against
  the per-sweep prediction; PageRank's iteration counts by its cadence;
  the negative cycle.

Results are tensors on the graph's device in the port (the JAX package
returns numpy arrays): each rank converts them.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as scsg
import torch

WORLD = 8
RANK_TIMEOUT = 240.0
SEMIRINGS = ("min-plus", "max-times", "or-and")
LAYOUTS = ("1d-row", "2d-block")
COLLECTIVE = {"min-plus": "pmin", "max-times": "pmax", "or-and": "por"}

# Semiring dist_spmv cases: name -> (matrix, shard_csr keywords, mesh).
DIST_CASES = {
    "halo": ("band", {}, "row"),
    "all-gather": ("random", {"force_all_gather": True}, "row"),
    "precise": ("random", {"precise": True}, "row"),
    "padded-csr": ("random", {"force_all_gather": True,
                              "ell_max_expand": 0.0}, "row"),
    "1d-col": ("random", {"layout": "1d-col"}, "row"),
    "2d-block": ("random", {"layout": "2d-block"}, "grid"),
}
SPMM_CASES = ("halo", "all-gather", "precise", "padded-csr")


def graph_csr(n=64, density=0.06, seed=0):
    rng = np.random.default_rng(seed)
    S = sp.random(n, n, density=density, random_state=rng)
    S.data[:] = rng.uniform(0.5, 2.0, S.data.shape)
    return S.tocsr()


def band_graph(n=64, reach=6, seed=5):
    """Random entries within ``reach`` of the diagonal: a halo window of
    at most ``reach`` at 8 ranks (8 rows a rank)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 4)
    c = np.clip(r + rng.integers(-reach, reach + 1, r.size), 0, n - 1)
    S = sp.csr_matrix((rng.uniform(0.5, 2.0, r.size), (r, c)), shape=(n, n))
    S.sum_duplicates()
    return S


def components_graph():
    """Two random blocks and isolated vertices (``test_graph.py:190``)."""
    rng = np.random.default_rng(31)
    B1 = sp.random(20, 20, density=0.15, random_state=rng)
    B2 = sp.random(30, 30, density=0.12, random_state=rng)
    return sp.block_diag([B1, B2, sp.csr_array((14, 14))]).tocsr()


def negative_cycle_graph():
    D = np.zeros((4, 4))
    D[0, 1] = 1.0
    D[1, 2] = -2.0
    D[2, 1] = -2.0
    D[2, 3] = 1.0
    return sp.csr_array(D)


def dist_inputs(name):
    kind = DIST_CASES[name][0]
    S = band_graph() if kind == "band" else graph_csr(64, 0.08, 7)
    x = np.random.default_rng(3).uniform(0, 1, 64)
    X = np.random.default_rng(4).uniform(0, 1, (64, 3))
    return S, x, X


def _operand(semiring, x):
    return x > 0.5 if semiring == "or-and" else x


def dense_semiring(S, x, semiring):
    """``A (x)`` over the stored structure (stored zeros are edges) by
    numpy, rows without an entry at the identity."""
    dense = S.toarray()
    mask = np.zeros(dense.shape, dtype=bool)
    mask[S.nonzero()] = True
    x2 = x if x.ndim == 2 else x[:, None]
    if semiring == "or-and":
        out = (mask[:, :, None] & x2[None, :, :]).any(axis=1)
    elif semiring == "min-plus":
        out = np.where(mask[:, :, None], dense[:, :, None] + x2[None],
                       np.inf).min(axis=1)
    else:
        out = np.where(mask[:, :, None], dense[:, :, None] * x2[None],
                       -np.inf).max(axis=1)
    return out if x.ndim == 2 else out[:, 0]


def pagerank_dense(S, n_iter=200):
    n = S.shape[0]
    M = np.zeros((n, n))
    outdeg = np.asarray(S.astype(bool).sum(axis=1)).ravel()
    for i, j in zip(*S.nonzero()):
        M[j, i] = 1.0 / outdeg[i]
    dang = (outdeg == 0).astype(float)
    r = np.full(n, 1.0 / n)
    for _ in range(n_iter):
        r = 0.85 * (M @ r + (dang @ r) / n) + 0.15 / n
    return r


# ------------------------------------------------------------- the ranks --

def _delta(c0, c1, prefixes=("op.", "comm.", "graph.")):
    return {k: v - c0.get(k, 0) for k, v in c1.items()
            if k.startswith(prefixes) and v != c0.get(k, 0)}


def _ranks(rank, world):
    """Every case on this rank; rank 0's results (numpy) go back."""
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import gallery, graph, obs
    from legate_sparse_tpu_torch import parallel as P, runtime
    from legate_sparse_tpu_torch.csgraph import NegativeCycleError
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    runtime.set_device("cpu")
    meshes = {"row": P.make_row_mesh(), "grid": P.make_grid_mesh(2, 4)}
    out = {}

    def arr(S):
        return tsparse.csr_array(S, device="cpu")

    # The semiring dist_spmv and dist_spmm.
    for name, (_kind, kw, mesh) in DIST_CASES.items():
        S, x, X = dist_inputs(name)
        dA = P.shard_csr(arr(S), mesh=meshes[mesh], **kw)
        for sr in SEMIRINGS:
            v = torch.from_numpy(_operand(sr, x))
            xs = D.shard_vector(v, dA.mesh, dA.rows_padded, layout=dA.layout)
            c0 = obs.counters.snapshot()
            y = P.dist_spmv(dA, xs, semiring=sr)
            res = {"counters": _delta(c0, obs.counters.snapshot()),
                   "y": y.full_tensor().numpy(), "path": dA.spmv_path,
                   "predicted": D.semiring_spmv_comm_volumes(
                       dA, v.element_size(),
                       1 if sr == "or-and" else 8, COLLECTIVE[sr])}
            if name in SPMM_CASES and sr != "max-times":
                Xs = P.shard_dense(torch.from_numpy(_operand(sr, X)),
                                   dA.mesh, dA.rows_padded)
                c0 = obs.counters.snapshot()
                res["Y"] = P.dist_spmm(dA, Xs, semiring=sr).full_tensor(
                    ).numpy()
                res["spmm_counters"] = _delta(c0, obs.counters.snapshot())
            out[name, sr] = res

    # The algorithms.
    A = arr(graph_csr(64, 0.05, 21))
    As = arr(graph_csr(64, 0.06, 23))
    Ac = arr(components_graph())
    Ap = arr(graph_csr(48, 0.08, 41))
    for lay in LAYOUTS:
        out["bfs", lay] = graph.bfs(A, 0, layout=lay).numpy()
        out["sssp", lay] = graph.sssp(As, 2, layout=lay).numpy()
        nc, lab = graph.connected_components(Ac, layout=lay)
        out["cc", lay] = (nc, lab.numpy())
        out["pagerank", lay] = graph.pagerank(Ap, layout=lay, tol=1e-12,
                                              max_iters=200).numpy()
    Ab = arr(graph_csr(64, 0.05, 51))
    out["bfs-batched"] = graph.bfs(Ab, [0, 7, 13], layout="1d-row").numpy()
    out["bfs-single"] = np.stack([graph.bfs(Ab, s, layout="1d-row").numpy()
                                  for s in (0, 7, 13)])
    out["bfs-batched-2d"] = graph.bfs(Ab, [0, 7], layout="2d-block").numpy()
    out["sssp-batched"] = graph.sssp(Ab, [0, 7], layout="1d-row").numpy()
    out["sssp-single"] = np.stack([graph.sssp(Ab, s, layout="1d-row").numpy()
                                   for s in (0, 7)])
    G = gallery.rmat(6, nnz_per_row=4, rng=np.random.default_rng(7),
                     directed=True, device="cpu")
    out["pagerank-multigraph"] = graph.pagerank(G, tol=1e-12,
                                                max_iters=300).numpy()
    Gs = G.toscipy().tocsr().copy()
    Gs.sum_duplicates()
    out["pagerank-simple"] = graph.pagerank(arr(Gs), tol=1e-12,
                                            max_iters=300).numpy()
    # BFS's comm counters against the per-sweep prediction.
    A2 = arr(graph_csr(64, 0.05, 61))
    obs.reset_all()
    graph.bfs(A2, 0, layout="2d-block")
    snap = obs.counters.snapshot()
    op, _ = graph.algorithms._push_operator(A2, directed=True,
                                            unweighted=True)
    out["bfs-comm"] = (
        snap, D.semiring_spmv_comm_volumes(
            P.shard_csr(op, layout="2d-block"), 1, 1, "por"))
    # PageRank's cadence.
    A3 = arr(graph_csr(40, 0.08, 71))
    obs.reset_all()
    pr5 = graph.pagerank(A3, tol=0.0, max_iters=10, conv_test_iters=5)
    out["cadence"] = (obs.counters.snapshot(), pr5.numpy(), graph.pagerank(
        A3, tol=0.0, max_iters=10, conv_test_iters=2).numpy())
    try:
        graph.sssp(arr(negative_cycle_graph()), 0)
        out["negative-cycle"] = None
    except NegativeCycleError as e:
        out["negative-cycle"] = str(e)
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
    from legate_sparse_tpu import obs as jobs
    from legate_sparse_tpu.parallel import (
        dist_spmm, dist_spmv, make_grid_mesh, make_row_mesh, shard_csr,
        shard_dense)
    from legate_sparse_tpu.parallel.dist_csr import shard_vector

    devs = jax.devices("cpu")
    if len(devs) < WORLD:
        pytest.skip("needs 8 virtual devices")
    meshes = {"row": make_row_mesh(devs[:WORLD]),
              "grid": make_grid_mesh(devs[:WORLD], shape=(2, 4))}
    one = make_row_mesh(devs[:1])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LEGATE_SPARSE_TPU_PALLAS_DIST", "interpret")
        jobs.enable()
        for name, (_kind, kw, mesh) in DIST_CASES.items():
            S, x, X = dist_inputs(name)
            dA = shard_csr(jsparse.csr_array(S), mesh=meshes[mesh], **kw)
            for sr in SEMIRINGS:
                xs = shard_vector(jnp.asarray(_operand(sr, x)), dA.mesh,
                                  dA.rows_padded, layout=dA.layout)
                jobs.reset_all()
                y = dist_spmv(dA, xs, semiring=sr)
                spans = [r for r in jobs.records()
                         if r.get("name") == "dist_spmv"]
                res = {"counters": _delta({}, jobs.snapshot()),
                       "y": np.asarray(y), "path": spans[-1]["attrs"]["path"]}
                if name in SPMM_CASES and sr != "max-times":
                    Xs = shard_dense(jnp.asarray(_operand(sr, X)), dA.mesh,
                                     dA.rows_padded)
                    jobs.reset_all()
                    res["Y"] = np.asarray(dist_spmm(dA, Xs, semiring=sr))
                    res["spmm_counters"] = _delta({}, jobs.snapshot())
                out[name, sr] = res
        jobs.disable()
        jobs.reset_all()
        A = jsparse.csr_array(graph_csr(64, 0.05, 21))
        As = jsparse.csr_array(graph_csr(64, 0.06, 23))
        Ac = jsparse.csr_array(components_graph())
        Ap = jsparse.csr_array(graph_csr(48, 0.08, 41))
        for lay in LAYOUTS:
            out["bfs", lay] = graph.bfs(A, 0, layout=lay, mesh=one)
            out["sssp", lay] = graph.sssp(As, 2, layout=lay, mesh=one)
            out["cc", lay] = graph.connected_components(Ac, layout=lay,
                                                        mesh=one)
            out["pagerank", lay] = graph.pagerank(Ap, layout=lay, mesh=one,
                                                  tol=1e-12,
                                                  max_iters=200)
        Ab = jsparse.csr_array(graph_csr(64, 0.05, 51))
        out["bfs-batched"] = graph.bfs(Ab, [0, 7, 13], layout="1d-row",
                                       mesh=one)
        out["sssp-batched"] = graph.sssp(Ab, [0, 7], layout="1d-row",
                                         mesh=one)
        G = gallery.rmat(6, nnz_per_row=4, rng=np.random.default_rng(7),
                         directed=True)
        out["pagerank-multigraph"] = graph.pagerank(G, tol=1e-12,
                                                    max_iters=300, mesh=one)
        jobs.reset_all()
    return out


# ----------------------------------------------------------------- tests --

def test_semiring_catalog():
    from legate_sparse_tpu_torch.graph import (
        MIN_PLUS, OR_AND, PLUS_TIMES, SEMIRINGS as CATALOG, resolve)
    from legate_sparse_tpu.graph import SEMIRINGS as JCATALOG

    assert set(CATALOG) == {"plus-times", "min-plus", "max-times", "or-and"}
    assert resolve("min-plus") is MIN_PLUS
    assert resolve(OR_AND) is OR_AND
    with pytest.raises(ValueError, match="plus-times"):
        resolve("tropical")
    f32 = torch.float32
    assert float(PLUS_TIMES.identity(f32)) == 0.0
    assert float(MIN_PLUS.identity(f32)) == np.inf
    assert float(CATALOG["max-times"].identity(f32)) == -np.inf
    assert bool(OR_AND.identity(torch.bool)) is False
    assert int(MIN_PLUS.identity(torch.int32)) == np.iinfo(np.int32).max
    for name, sr in CATALOG.items():
        j = JCATALOG[name]
        assert (sr.add, sr.mul, sr.collective) == (j.add, j.mul,
                                                   j.collective)
        for dt, jdt in ((torch.float32, np.float32), (torch.int32, np.int32),
                        (torch.bool, np.bool_)):
            assert torch.equal(sr.annihilator(dt), sr.identity(dt))
            assert sr.identity(dt).item() == np.asarray(
                j.identity(np.dtype(jdt))).item()


@pytest.mark.parametrize("semiring", ("plus-times",) + SEMIRINGS)
@pytest.mark.parametrize("kernel", ("semiring-csr", "semiring-ell",
                                    "semiring-sliced-ell"))
def test_matvec(semiring, kernel):
    """``graph.matvec`` against the JAX package's, kernel by kernel:
    min, max and or bit for bit (and equal to the dense reference);
    plus-times bit for bit with the port's own plus-times sibling and
    within 1e-13 of the JAX package's."""
    import jax.numpy as jnp

    import legate_sparse_tpu as jsparse
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu import graph as jgraph
    from legate_sparse_tpu_torch import graph
    from legate_sparse_tpu_torch.ops import spmv as spv

    S = graph_csr(72, 0.07, 5)
    A = tsparse.csr_array(S, device="cpu")
    x = np.random.default_rng(2).uniform(0, 1, 72)
    v = _operand(semiring, x)
    got = graph.matvec(A, torch.from_numpy(v), semiring=semiring,
                       kernel=kernel)
    want = np.asarray(jgraph.matvec(jsparse.csr_array(S), jnp.asarray(v),
                                    semiring=semiring, kernel=kernel))
    if semiring == "plus-times":
        sibling = {
            "semiring-csr": lambda: spv.csr_spmv_rowids(
                A.data, A.indices, A._get_row_ids(), torch.from_numpy(x), 72),
            "semiring-ell": lambda: spv.ell_spmv(*A._get_ell(),
                                                 torch.from_numpy(x)),
            "semiring-sliced-ell": lambda: spv.sliced_ell_spmv(
                A._get_sliced_ell(), torch.from_numpy(x), 72),
        }[kernel]()
        assert torch.equal(got, sibling)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)
        return
    assert got.dtype == (torch.bool if semiring == "or-and"
                         else torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), dense_semiring(S, v, semiring))


def test_matvec_unknown_kernel():
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import graph

    A = tsparse.csr_array(graph_csr(16, 0.2, 1), device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        graph.matvec(A, torch.ones(16, dtype=torch.float64),
                     kernel="no-such-kernel")


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("name", sorted(DIST_CASES))
def test_dist_semiring_spmv(port, jax_side, name, semiring):
    """The semiring ``dist_spmv``: bit for bit with the JAX package's and
    the dense reference, the same route, and the one call's counters
    equal to the JAX package's and to ``semiring_spmv_comm_volumes``."""
    p, j = port[name, semiring], jax_side[name, semiring]
    S, x, _ = dist_inputs(name)
    np.testing.assert_array_equal(p["y"][:64], j["y"][:64])
    np.testing.assert_array_equal(p["y"][:64],
                                  dense_semiring(S, _operand(semiring, x),
                                                 semiring))
    assert p["path"] == j["path"]
    assert p["counters"] == j["counters"]
    assert p["counters"]["graph.dist_spmv." + semiring] == 1
    for kind, nbytes in p["predicted"].items():
        assert p["counters"][f"comm.dist_spmv.{kind}_bytes"] == nbytes
    if name == "2d-block":
        assert COLLECTIVE[semiring] in p["predicted"]


@pytest.mark.parametrize("semiring", ("min-plus", "or-and"))
@pytest.mark.parametrize("name", SPMM_CASES)
def test_dist_semiring_spmm(port, jax_side, name, semiring):
    """The batched semiring ``dist_spmm``: bit for bit with the JAX
    package's and the dense reference, its counters equal."""
    p, j = port[name, semiring], jax_side[name, semiring]
    S, _, X = dist_inputs(name)
    np.testing.assert_array_equal(p["Y"][:64], j["Y"][:64])
    np.testing.assert_array_equal(
        p["Y"][:64], dense_semiring(S, _operand(semiring, X), semiring))
    assert p["spmm_counters"] == j["spmm_counters"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bfs(port, jax_side, layout):
    lv = port["bfs", layout]
    np.testing.assert_array_equal(lv, jax_side["bfs", layout])
    ref = scsg.dijkstra(graph_csr(64, 0.05, 21), indices=0, unweighted=True)
    np.testing.assert_array_equal(lv, np.where(np.isinf(ref), -1, ref))
    assert lv.dtype == np.int32


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sssp(port, jax_side, layout):
    d = port["sssp", layout]
    np.testing.assert_array_equal(d, jax_side["sssp", layout])
    np.testing.assert_allclose(
        d, scsg.dijkstra(graph_csr(64, 0.06, 23), indices=2), rtol=1e-12)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_connected_components(port, jax_side, layout):
    nc, lab = port["cc", layout]
    jnc, jlab = jax_side["cc", layout]
    assert nc == jnc
    np.testing.assert_array_equal(lab, jlab)
    rnc, rlab = scsg.connected_components(components_graph(), directed=False)
    assert nc == rnc
    assert len(set(zip(lab.tolist(), rlab.tolist()))) == nc


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pagerank(port, jax_side, layout):
    pr = port["pagerank", layout]
    np.testing.assert_allclose(pr, jax_side["pagerank", layout], rtol=1e-12)
    np.testing.assert_allclose(pr, pagerank_dense(graph_csr(48, 0.08, 41)),
                               atol=1e-8)
    np.testing.assert_allclose(pr.sum(), 1.0, atol=1e-6)


def test_batched_multi_source(port, jax_side):
    """Batched BFS and SSSP (one ``dist_spmm`` sweep for every source)
    bit for bit with the per-source runs and the JAX package's batch;
    on 2d-block a batch is a loop of per-source runs."""
    np.testing.assert_array_equal(port["bfs-batched"], port["bfs-single"])
    np.testing.assert_array_equal(port["bfs-batched"],
                                  jax_side["bfs-batched"])
    np.testing.assert_array_equal(port["bfs-batched-2d"],
                                  port["bfs-single"][:2])
    np.testing.assert_array_equal(port["sssp-batched"], port["sssp-single"])
    np.testing.assert_array_equal(port["sssp-batched"],
                                  jax_side["sssp-batched"])
    S = graph_csr(64, 0.05, 51)
    for i, s in enumerate((0, 7)):
        np.testing.assert_allclose(port["sssp-batched"][i],
                                   scsg.dijkstra(S, indices=s), rtol=1e-12)


def test_pagerank_multigraph_conserves_mass(port, jax_side):
    """A duplicated edge list counts each (row, col) once in the
    out-degrees: rank over the multigraph equals rank over its simple
    graph, and sums to 1."""
    pr = port["pagerank-multigraph"]
    np.testing.assert_allclose(pr.sum(), 1.0, atol=1e-6)
    np.testing.assert_allclose(pr, port["pagerank-simple"], atol=1e-8)
    np.testing.assert_allclose(pr, jax_side["pagerank-multigraph"],
                               rtol=1e-12)


def test_algorithm_comm_counters(port):
    """BFS on 2d-block: one semiring ``dist_spmv`` a sweep plus the
    terminating one, each priced as ``semiring_spmv_comm_volumes``
    predicts, the or-and add all-reduced as ``por``."""
    snap, vols = port["bfs-comm"]
    calls = snap["graph.dist_spmv.or-and"]
    assert calls == snap["graph.bfs.iters"] + 1
    assert snap["transfer.host_sync.graph_bfs"] == calls
    assert "por" in vols
    for kind, nbytes in vols.items():
        assert snap[f"comm.dist_spmv.{kind}_bytes"] == calls * nbytes


def test_pagerank_cadence_and_knobs(port):
    """tol=0 never converges: exactly ``max_iters`` iterations whatever
    the fetch cadence, one fetch a cycle."""
    from legate_sparse_tpu_torch.settings import settings

    assert settings.graph_conv_iters == 5 and settings.graph_max_iters == 0
    snap, pr5, pr2 = port["cadence"]
    assert snap["graph.pagerank.iters"] == 10
    assert snap["graph.pagerank.runs"] == 1
    assert snap["transfer.host_sync.graph_pagerank"] == 2
    np.testing.assert_allclose(pr5, pr2, rtol=1e-12)


def test_sssp_negative_cycle_raises(port):
    assert port["negative-cycle"] is not None
    assert "negative cycle" in port["negative-cycle"]
