# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``csgraph`` and semiring products against the JAX
package's, on the CPU.

Mirrors every case of ``test_csgraph.py``: the same graphs (built by
scipy from the same seeds) go to both packages, and where a case holds
the JAX package to scipy, the port is held to the JAX package and to
scipy.

Tolerances.  Labels, component counts, predecessors, MST edge sets and
the min/max semiring products are bit for bit (min and max do not
depend on the order of their operands, and the (weight, stored index)
order of the MST is strict).  Distances agree to 1e-12 relative
(Floyd-Warshall's and the relaxation's sums are the same additions, so
they are in fact equal), Laplacian values to 1e-12 (a normalised one
divides by square roots computed by each library), and the sum
semiring to 1e-12 (a segment sum).  Scipy's own answers are held at the
JAX tests' tolerances.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as scsg
import torch

import legate_sparse_tpu as jsparse
from legate_sparse_tpu.ops import spmv as jspmv

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.ops import spmv as tspmv

jcsg = jsparse.csgraph
tcsg = tsparse.csgraph


@pytest.fixture(autouse=True)
def _cpu():
    runtime.set_device("cpu")
    yield
    runtime.set_device(None)


def host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.toarray() if hasattr(x, "toarray") else np.asarray(x)


def pair(S):
    return jsparse.csr_array(S), tsparse.csr_array(S, device="cpu")


def dense(A):
    """A port or JAX sparse result as a dense numpy array."""
    if isinstance(A, tsparse.csr_array):
        return A.toscipy().toarray()
    return np.asarray(A.todense())


def graph(n=200, density=0.01, seed=0, sym=True):
    rng = np.random.default_rng(seed)
    E = sp.random(n, n, density=density, format="csr", random_state=rng)
    E = ((E + E.T) > 0) if sym else (E > 0)
    return E.astype(np.float64).tocsr()


def weighted(n=80, density=0.06, seed=4, negative=False):
    rng = np.random.default_rng(seed)
    E = sp.random(n, n, density=density, format="csr", random_state=rng)
    w = rng.uniform(0.5, 3.0, size=E.nnz)
    if negative:
        # Negative edges only from u to v > u: a DAG part, no cycle.
        r, c = E.tocoo().row, E.tocoo().col
        w = np.where((r < c) & (rng.random(E.nnz) < 0.2), -w * 0.1, w)
    return sp.csr_array((w, E.indices, E.indptr), shape=(n, n))


def same(got, want):
    assert isinstance(got, torch.Tensor), type(got)
    np.testing.assert_array_equal(host(got), np.asarray(want))


def close(got, want, rtol=1e-12):
    assert isinstance(got, torch.Tensor), type(got)
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=rtol,
                               atol=0)


# ----------------------------------------------------- semiring products


def semiring_case(seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    S = sp.random(40, 30, density=0.15, format="csr", random_state=rng)
    S.data = rng.standard_normal(S.nnz).astype(dtype)
    row_ids = np.repeat(np.arange(40), np.diff(S.indptr))
    X = rng.standard_normal((30, 3)).astype(dtype)
    X[rng.integers(0, 30, 5), 0] = np.inf
    return S, row_ids, X


# The boolean semiring ("and") adds with max (or), or min.
@pytest.mark.parametrize("add,mul", [
    (a, m) for a in ("min", "max", "sum") for m in ("plus", "times")]
    + [("min", "and"), ("max", "and")])
def test_semiring_products_match_jax(add, mul):
    S, row_ids, X = semiring_case(1)
    if mul == "and":
        X = X != 0
    valid = S.nnz - 7        # a padded suffix takes the identity
    args = (S.data, S.indices, row_ids)
    tj = tuple(torch.from_numpy(np.array(a)) for a in args)
    for j_fn, t_fn, x in (
            (jspmv.csr_semiring_spmv_rowids_masked,
             tspmv.csr_semiring_spmv_rowids_masked, X[:, 0]),
            (jspmv.csr_semiring_spmm_rowids_masked,
             tspmv.csr_semiring_spmm_rowids_masked, X)):
        want = np.asarray(j_fn(*args, valid, x, 40, add, mul))
        got = t_fn(*tj, valid, torch.from_numpy(x), 40, add, mul)
        assert got.dtype == torch.from_numpy(want).dtype
        if add == "sum":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("add,dtype", [
    (a, d) for a in ("sum", "min", "max")
    for d in (torch.float32, torch.int32)]
    + [("min", torch.bool), ("max", torch.bool)])
def test_semiring_identity(add, dtype):
    import jax.numpy as jnp

    jdt = {torch.float32: jnp.float32, torch.int32: jnp.int32,
           torch.bool: jnp.bool_}[dtype]
    got = tspmv.semiring_identity(add, dtype)
    want = np.asarray(jspmv.semiring_identity(add, jdt))
    assert got.dim() == 0 and got.dtype == dtype
    assert got.item() == want.item()


# ------------------------------------------------ connected components


def test_connected_components_undirected():
    E = graph()
    J, T = pair(E)
    k, labels = tcsg.connected_components(T, directed=False)
    kj, lj = jcsg.connected_components(J, directed=False)
    k_ref, l_ref = scsg.connected_components(E, directed=False)
    assert k == kj == k_ref
    same(labels, lj)
    same(labels, l_ref)


def test_connected_components_weak_and_strong():
    E = graph(density=0.008, sym=False)
    J, T = pair(E)
    for connection in ("weak", "strong"):
        k, labels = tcsg.connected_components(T, directed=True,
                                              connection=connection)
        kj, lj = jcsg.connected_components(J, directed=True,
                                           connection=connection)
        assert k == kj
        same(labels, np.asarray(lj))


def test_connected_components_count_only_and_isolated():
    rows, cols = np.array([0, 1, 3, 4]), np.array([1, 0, 4, 3])
    T = tsparse.csr_array((np.ones(4), (rows, cols)), shape=(6, 6),
                          device="cpu")
    J = jsparse.csr_array((np.ones(4), (rows, cols)), shape=(6, 6))
    k = tcsg.connected_components(T, directed=False, return_labels=False)
    assert k == jcsg.connected_components(J, directed=False,
                                          return_labels=False) == 4


# ------------------------------------------------------------ laplacian


@pytest.mark.parametrize("kw", [
    {}, {"normed": True}, {"use_out_degree": True},
    {"symmetrized": True}, {"dtype": np.float32},
])
def test_laplacian_matches_jax(kw):
    # An asymmetric graph: row sums differ from column sums, so a
    # swapped degree axis cannot slip through.
    E = graph(seed=1, density=0.02, sym=False)
    J, T = pair(E)
    L, d = tcsg.laplacian(T, return_diag=True, **kw)
    Lj, dj = jcsg.laplacian(J, return_diag=True, **kw)
    ref = scsg.laplacian(E, return_diag=True, **kw)
    assert L.dtype == torch.from_numpy(np.asarray(dj)).dtype
    np.testing.assert_allclose(dense(L), dense(Lj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(host(d), np.asarray(dj), rtol=1e-12)
    np.testing.assert_allclose(dense(L), ref[0].toarray(), atol=1e-6)


def test_laplacian_self_loops():
    # Degrees exclude self-loops; the diagonal is overwritten.
    S = (graph(n=60, seed=2) + 3.0 * sp.eye(60)).tocsr()
    J, T = pair(S)
    for kw in ({}, {"normed": True}):
        L, d = tcsg.laplacian(T, return_diag=True, **kw)
        Lj, dj = jcsg.laplacian(J, return_diag=True, **kw)
        np.testing.assert_allclose(dense(L), dense(Lj), atol=1e-12)
        np.testing.assert_allclose(host(d), np.asarray(dj), rtol=1e-12)


def test_laplacian_product_takes_the_dispatch():
    # L @ x through the port's SpMV dispatch equals scipy's product.
    E = graph(n=300, density=0.02, seed=5)
    _, T = pair(E)
    L = tcsg.laplacian(T, normed=True)
    x = np.random.default_rng(0).standard_normal(300)
    y = L @ torch.from_numpy(x)
    assert L.spmv_path is not None
    np.testing.assert_allclose(y.numpy(), scsg.laplacian(E, normed=True) @ x,
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------------- shortest paths


@pytest.mark.parametrize("method", ["auto", "D", "BF", "J", "FW"])
@pytest.mark.parametrize("directed", [True, False])
def test_shortest_path_matches_jax(method, directed):
    E = weighted()
    J, T = pair(E)
    got = tcsg.shortest_path(T, method=method, directed=directed)
    close(got, jcsg.shortest_path(J, method=method, directed=directed))
    close(got, scsg.shortest_path(E, method=method, directed=directed),
          rtol=1e-10)


def test_shortest_path_unweighted_and_indices():
    E = weighted(seed=5)
    J, T = pair(E)
    close(tcsg.shortest_path(T, unweighted=True),
          jcsg.shortest_path(J, unweighted=True))
    close(tcsg.bellman_ford(T, indices=[3, 7]),
          jcsg.bellman_ford(J, indices=[3, 7]))
    got = tcsg.dijkstra(T, indices=2)
    assert got.shape == (E.shape[0],)
    close(got, jcsg.dijkstra(J, indices=2))


def test_negative_weights_and_cycle():
    E = weighted(seed=6, negative=True)
    J, T = pair(E)
    for name in ("bellman_ford", "johnson", "floyd_warshall"):
        close(getattr(tcsg, name)(T), getattr(jcsg, name)(J))
    with pytest.warns(UserWarning, match="negative weights"):
        close(tcsg.dijkstra(T), jcsg.bellman_ford(J))
    rows, cols = np.array([0, 1]), np.array([1, 0])
    C = tsparse.csr_array((np.array([1.0, -3.0]), (rows, cols)),
                          shape=(2, 2), device="cpu")
    with pytest.raises(scsg.NegativeCycleError):
        tcsg.bellman_ford(C)
    with pytest.raises(scsg.NegativeCycleError):
        tcsg.floyd_warshall(C)
    assert tcsg.NegativeCycleError is scsg.NegativeCycleError


def check_predecessors(dist, pred, E, directed):
    """Every reachable non-source node's predecessor edge exists and is
    tight."""
    coo = E.tocoo()
    W = np.full(E.shape, np.inf)
    W[coo.row, coo.col] = coo.data
    if not directed:
        W = np.minimum(W, W.T)
    for i in range(dist.shape[0]):
        for j in range(dist.shape[1]):
            p = pred[i, j]
            if p == -9999:
                continue
            assert np.isfinite(W[p, j])
            np.testing.assert_allclose(dist[i, p] + W[p, j], dist[i, j],
                                       rtol=1e-10)


@pytest.mark.parametrize("directed", [True, False])
def test_predecessors_match_jax(directed):
    E = weighted(n=40, density=0.1, seed=7)
    J, T = pair(E)
    dist, pred = tcsg.shortest_path(T, return_predecessors=True,
                                    directed=directed)
    dj, pj = jcsg.shortest_path(J, return_predecessors=True,
                                directed=directed)
    close(dist, dj)
    same(pred, pj)
    assert pred.dtype == torch.int32
    check_predecessors(host(dist), host(pred), E, directed)
    dist, pred = tcsg.floyd_warshall(T, return_predecessors=True,
                                     directed=directed)
    dj, pj = jcsg.floyd_warshall(J, return_predecessors=True,
                                 directed=directed)
    close(dist, dj)
    same(pred, pj)
    check_predecessors(host(dist), host(pred), E, directed)


def test_dijkstra_limit_and_min_only():
    E = weighted(n=60, density=0.08, seed=8)
    J, T = pair(E)
    close(tcsg.dijkstra(T, limit=2.5), jcsg.dijkstra(J, limit=2.5))
    close(tcsg.dijkstra(T, indices=[0, 9], min_only=True),
          jcsg.dijkstra(J, indices=[0, 9], min_only=True))
    got = tcsg.dijkstra(T, indices=[0, 9], min_only=True,
                        return_predecessors=True)
    want = jcsg.dijkstra(J, indices=[0, 9], min_only=True,
                         return_predecessors=True)
    close(got[0], want[0])
    same(got[1], want[1])
    same(got[2], want[2])
    np.testing.assert_array_equal(
        host(got[2]), scsg.dijkstra(E, indices=[0, 9], min_only=True,
                                    return_predecessors=True)[2])


def test_unreachable_predecessors_and_bad_indices():
    # Only the edge 1 -> 2: from 0 nothing is reachable, and inf + w ==
    # inf must not make pred[2] = 1.
    T = tsparse.csr_array((np.array([1.0]), (np.array([1]), np.array([2]))),
                          shape=(3, 3), device="cpu")
    dist, pred = tcsg.bellman_ford(T, indices=[0], return_predecessors=True)
    same(pred, [[-9999, -9999, -9999]])
    assert np.isinf(host(dist)[0, 1]) and np.isinf(host(dist)[0, 2])
    close(tcsg.dijkstra(T, indices=-2), [np.inf, 0.0, 1.0])
    with pytest.raises(ValueError):
        tcsg.dijkstra(T, indices=[3])


def test_shortest_path_stored_zero_edges():
    B = sp.csr_array((np.array([1.0, 0.0, 2.0]), np.array([1, 2, 2]),
                      np.array([0, 2, 3, 3])), shape=(3, 3))
    J, T = pair(B)
    close(tcsg.shortest_path(T), jcsg.shortest_path(J))
    close(tcsg.floyd_warshall(T), jcsg.floyd_warshall(J))
    close(tcsg.shortest_path(T), scsg.shortest_path(B))


# ---------------------------------------------------- spanning trees


def mst_same(S):
    J, T = pair(S)
    got = tcsg.minimum_spanning_tree(T)
    want = jcsg.minimum_spanning_tree(J)
    assert isinstance(got, tsparse.csr_array)
    assert got.dtype == torch.float64 and got.nnz == want.nnz
    np.testing.assert_array_equal(dense(got), dense(want))
    return got


def test_fallbacks_take_package_arrays():
    # Distinct weights, so the tree is unique; a scipy-only name takes
    # the port's arrays and returns the port's objects.
    E = weighted(n=60, density=0.1, seed=3)
    Es = ((E + E.T) / 2).tocsr()
    got = mst_same(Es)
    np.testing.assert_allclose(dense(got),
                               scsg.minimum_spanning_tree(Es).toarray())
    _, T = pair(Es)
    order = tcsg.breadth_first_order(T, 0, return_predecessors=False)
    assert isinstance(order, torch.Tensor)
    np.testing.assert_array_equal(
        host(order), scsg.breadth_first_order(Es, 0,
                                              return_predecessors=False))


def test_minimum_spanning_tree_native():
    rng = np.random.default_rng(12)
    for _ in range(6):
        n = int(rng.integers(5, 60))
        Eu = sp.triu(sp.random(n, n, density=0.2, random_state=rng),
                     k=1).tocoo()
        w = rng.permutation(len(Eu.data)) + 1.0
        S = sp.csr_array((np.concatenate([w, w]),
                          (np.concatenate([Eu.row, Eu.col]),
                           np.concatenate([Eu.col, Eu.row]))), shape=(n, n))
        got = mst_same(S)
        np.testing.assert_allclose(dense(got),
                                   scsg.minimum_spanning_tree(S).toarray())
    # Stored direction kept; a forest.
    for rows in ([[0, 0, 0], [4.0, 0, 0], [0, 1.0, 0]],
                 [[0, 1.0, 0, 0]] + [[0] * 4] * 3,
                 [[0, 1.0, 1.0, 0], [1.0, 0, 1.0, 0], [1.0, 1.0, 0, 1.0],
                  [0, 0, 1.0, 0]]):
        mst_same(sp.csr_array(np.array(rows)))
    # A chosen zero-weight edge vanishes from the structure (scipy).
    Z = sp.csr_array(np.array([[0, 0, 2.0], [0, 0, 3.0], [0, 0, 0]]))
    Z[0, 1] = 0.0
    Z[1, 0] = 0.0
    got = mst_same(Z)
    assert got.nnz == scsg.minimum_spanning_tree(Z).nnz
    Zi = sp.csr_array(np.array([[0, 3, 2], [0, 0, 1], [0, 0, 0]],
                               dtype=np.int64))
    assert mst_same(Zi).dtype == torch.float64


def test_minimum_spanning_tree_tie_breaking_deterministic():
    # Weights from {1, 2, 3} only: the (weight, row, col) order picks
    # the same stored edges in both packages.
    rng = np.random.default_rng(7)
    for _ in range(3):
        n = int(rng.integers(6, 40))
        Eu = sp.triu(sp.random(n, n, density=0.25, random_state=rng),
                     k=1).tocoo()
        w = rng.integers(1, 4, size=len(Eu.data)).astype(np.float64)
        S = sp.csr_array((np.concatenate([w, w]),
                          (np.concatenate([Eu.row, Eu.col]),
                           np.concatenate([Eu.col, Eu.row]))), shape=(n, n))
        got = mst_same(S)
        np.testing.assert_allclose(dense(got).sum(),
                                   scsg.minimum_spanning_tree(S).sum())
    D = sp.random(30, 30, density=0.15, random_state=rng).tocsr()
    D.data[:] = rng.integers(1, 3, size=D.nnz).astype(np.float64)
    D.setdiag(0)
    D.eliminate_zeros()
    mst_same(D)
    _, T = pair(S)
    np.testing.assert_array_equal(dense(tcsg.minimum_spanning_tree(T)),
                                  dense(got))


def test_module_names():
    assert tsparse.csgraph is tcsg
    assert tcsg.__name__ == "legate_sparse_tpu_torch.csgraph"
    with pytest.raises(AttributeError):
        tcsg.definitely_not_a_name  # noqa: B018
