# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Distributed graph algorithms as iterated semiring ``dist_spmv``.

Counterpart of ``legate_sparse_tpu/graph/algorithms.py``.  Each
algorithm builds the push operator (the transposed, or symmetrised,
adjacency, so one semiring SpMV moves information along the edges) on
the graph's device, shards it with ``shard_csr`` and iterates ``y = A_T
(x)`` under its semiring, with a host loop that fetches one scalar a
sweep:

- :func:`bfs` — or-and frontier push; a vertex's level is the sweep that
  first reaches it;
- :func:`sssp` — Bellman-Ford min-plus relaxation;
- :func:`connected_components` — min-label propagation: min-plus over
  the zero-weighted symmetrised structure;
- :func:`pagerank` — damped plus-times power iteration on the
  column-normalised transpose, its convergence fetched once every
  ``conv_test_iters`` iterations.

Multi-source BFS and SSSP stack their frontiers as one (rows, S) operand
through ``dist_spmm(..., semiring=)`` (one realization a sweep for all
S sources); the 2-d layouts have no SpMM, so there each source runs on
its own.

SPMD: every rank calls an algorithm with the same graph, as it calls
``shard_csr``.  The sweeps run on this rank's blocks; the "anything
new?" test is one all-reduce over the vector's ranks and one host fetch
(``linalg._host_fetch``, counted as ``transfer.host_sync.graph_<alg>``).
The result is a tensor on the graph's device, the same on every rank
(the JAX package returns a numpy array).

Counters ``graph.<alg>.runs``/``graph.<alg>.iters``, timers
``lat.graph.<alg>``, spans ``graph.<alg>``, beside the dispatch layer's
``graph.dist_spmv.<name>``/``graph.dist_spmm.<name>``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..obs import counters as _counters
from ..obs import latency as _latency
from ..obs import trace as _trace


def _csr_from_edges(rows, cols, vals, n: int):
    """``csr_array`` of an edge list on its device, one entry per
    (row, col): the smallest value of its duplicates (symmetrisation
    stages both stored copies of an undirected edge, and min/or algebra
    wants one representative).  Two stable sorts, by value then by key,
    are the JAX package's host ``lexsort`` (``algorithms.py:54``)."""
    from ..csr import csr_array

    dev = vals.device
    if n == 0 or rows.numel() == 0:
        return csr_array((vals[:0], rows.new_zeros((0,)),
                          torch.zeros(n + 1, dtype=torch.int64, device=dev)),
                         shape=(n, n))
    key = rows * n + cols
    order = torch.argsort(vals, stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    key, vals = key[order], vals[order]
    first = torch.ones(key.shape[0], dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    key, vals = key[first], vals[first]
    rows, cols = key // n, key % n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return csr_array((vals, cols, indptr), shape=(n, n))


def _push_operator(csgraph, directed: bool, unweighted: bool,
                   zero_weights: bool = False):
    """The transposed traversal operator A_T: ``y = A_T (x)`` pushes x
    along the edges (row u -> col v gives x[u] to y[v]).
    ``zero_weights`` puts an int32 0 on every edge (label propagation as
    min-plus, in integer algebra throughout)."""
    from ..csgraph import _graph_edges

    rows, cols, w, n = _graph_edges(csgraph, directed, unweighted)
    if zero_weights:
        w = torch.zeros(w.shape, dtype=torch.int32, device=w.device)
    return _csr_from_edges(cols, rows, w, n), n


def _shard_operator(op, mesh, layout):
    from ..parallel import dist_csr as _dc

    return _dc.shard_csr(op, mesh=mesh, layout=layout)


def _block(v: torch.Tensor, dA) -> torch.Tensor:
    """This rank's block of a whole vector (or (n, S) block of vectors),
    padded to ``rows_padded``."""
    from ..parallel import dist_csr as _dc

    return _dc._local_rows(v.to(dA.device), dA.local_len,
                           _dc._chunk_index(dA.mesh, dA.layout),
                           dA.rows_padded)


def _whole(local: torch.Tensor, dA, n: int) -> torch.Tensor:
    """The first ``n`` rows of a sharded vector, gathered on every
    rank."""
    from ..parallel import dist_csr as _dc

    full = _dc._unwire(_dc._all_gather(_dc._wire(local), dA.vector_group),
                       local.dtype)
    return full[:n]


def _fetch_any(mask: torch.Tensor, dA, alg: str) -> bool:
    """Whether any rank's ``mask`` holds a True: one all-reduce over the
    vector's ranks and one host fetch."""
    from ..linalg import _host_fetch

    flag = mask.any().to(torch.int32).reshape(1)
    if dist.get_world_size(dA.vector_group) > 1:
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=dA.vector_group)
    _counters.handle("transfer.host_sync.graph_" + alg).inc()
    return bool(_host_fetch(flag)[0])


def _max_iters(n: int, max_iters: Optional[int]) -> int:
    from ..settings import settings

    if max_iters is not None:
        return int(max_iters)
    cap = settings.graph_max_iters
    return int(cap) if cap > 0 else n + 1


def _sources(source, n: int, alg: str):
    src = torch.atleast_1d(torch.as_tensor(source, dtype=torch.int64))
    if src.numel() and bool(((src < 0) | (src >= n)).any()):
        raise ValueError(f"{alg}: source out of range for n={n}")
    return src.cpu(), torch.as_tensor(source).dim() == 0


def _bfs_sweeps(dA, f, levels, cap: int, push):
    """Frontier sweeps from ``f`` until no vertex is new (or ``cap``):
    a vertex's level is the sweep that first reaches it."""
    visited = f
    it = 0
    while it < cap:
        new = push(f) & ~visited
        if not _fetch_any(new, dA, "bfs"):
            break
        it += 1
        levels = torch.where(new, torch.tensor(it, dtype=torch.int32,
                                               device=dA.device), levels)
        visited = visited | new
        f = new
    _counters.inc("graph.bfs.iters", it)
    return levels


def bfs(csgraph, source=0, *, directed: bool = True, mesh=None,
        layout=None, max_iters: Optional[int] = None):
    """BFS levels by or-and frontier push (``algorithms.py:113``).

    Returns the int32 levels (hops from the source; -1 unreachable):
    shape (n,) for a scalar ``source``, (S, n) for a sequence (one
    ``dist_spmm`` sweep advances all S frontiers on the 1-d layouts).
    Each sweep fetches one scalar ("any new vertex?")."""
    from ..parallel import dist_csr as _dc

    op, n = _push_operator(csgraph, directed, unweighted=True)
    sources, scalar = _sources(source, n, "bfs")
    dA = _shard_operator(op, mesh, layout)
    cap = _max_iters(n, max_iters)
    _counters.inc("graph.bfs.runs")
    with _latency.timer("lat.graph.bfs"), \
            _trace.span("graph.bfs", n=n, sources=int(sources.numel()),
                        layout=dA.layout) as sp:
        batched = sources.numel() > 1 and dA.grid is None
        if sp is not None:
            sp.set(batched=batched)
        if not batched:
            outs = []
            for s in sources:
                f0 = torch.zeros(n, dtype=torch.bool)
                f0[s] = True
                l0 = torch.full((n,), -1, dtype=torch.int32)
                l0[s] = 0
                levels = _bfs_sweeps(
                    dA, _block(f0, dA), _block(l0, dA), cap,
                    lambda v: _dc.dist_spmv(dA, v, semiring="or-and"))
                outs.append(_whole(levels, dA, n))
            return outs[0] if scalar else torch.stack(outs)
        S = int(sources.numel())
        cols = torch.arange(S)
        F0 = torch.zeros((n, S), dtype=torch.bool)
        F0[sources, cols] = True
        L0 = torch.full((n, S), -1, dtype=torch.int32)
        L0[sources, cols] = 0
        levels = _bfs_sweeps(
            dA, _block(F0, dA), _block(L0, dA), cap,
            lambda v: _dc.dist_spmm(dA, v, semiring="or-and"))
    return _whole(levels, dA, n).T.contiguous()


def sssp(csgraph, source=0, *, directed: bool = True,
         unweighted: bool = False, mesh=None, layout=None,
         max_iters: Optional[int] = None):
    """Single- or multi-source shortest paths by Bellman-Ford min-plus
    relaxation (``algorithms.py:193``): right for negative weights, and
    ``csgraph.NegativeCycleError`` on a reachable negative cycle.

    Returns float distances, inf where unreachable: (n,) for a scalar
    source, (S, n) for a sequence (batched through the semiring
    ``dist_spmm`` on the 1-d layouts)."""
    from ..csgraph import NegativeCycleError
    from ..parallel import dist_csr as _dc

    op, n = _push_operator(csgraph, directed, unweighted)
    sources, scalar = _sources(source, n, "sssp")
    dA = _shard_operator(op, mesh, layout)
    fdt = op.dtype
    # Bellman-Ford settles in n - 1 relaxations without a negative
    # cycle; one that still improves at the n-th proves one, so the cap
    # is the detector, not a budget.
    cap = n if max_iters is None else _max_iters(n, max_iters)
    _counters.inc("graph.sssp.runs")
    with _latency.timer("lat.graph.sssp"), \
            _trace.span("graph.sssp", n=n, sources=int(sources.numel()),
                        layout=dA.layout) as sp:
        batched = sources.numel() > 1 and dA.grid is None
        if batched:
            S = int(sources.numel())
            D0 = torch.full((n, S), torch.inf, dtype=fdt)
            D0[sources, torch.arange(S)] = 0.0
            dist_v = _block(D0, dA)

            def spmv(v):
                return _dc.dist_spmm(dA, v, semiring="min-plus")
        else:
            if sources.numel() > 1:
                return torch.stack([
                    sssp(csgraph, int(s), directed=directed,
                         unweighted=unweighted, mesh=mesh, layout=layout,
                         max_iters=max_iters) for s in sources])
            d0 = torch.full((n,), torch.inf, dtype=fdt)
            d0[int(sources[0])] = 0.0
            dist_v = _block(d0, dA)

            def spmv(v):
                return _dc.dist_spmv(dA, v, semiring="min-plus")
        it = 0
        while True:
            new = torch.minimum(dist_v, spmv(dist_v))
            if not _fetch_any(new < dist_v, dA, "sssp"):
                break
            it += 1
            dist_v = new
            if it >= cap:
                raise NegativeCycleError(
                    "sssp: still relaxing after n sweeps — reachable "
                    "negative cycle")
        _counters.inc("graph.sssp.iters", it)
        if sp is not None:
            sp.set(iters=it, batched=batched)
    out = _whole(dist_v, dA, n)
    if batched:
        return out.T.contiguous()
    return out if scalar else out[None, :]


def connected_components(csgraph, *, mesh=None, layout=None,
                         max_iters: Optional[int] = None):
    """Weak connected components by min-label propagation
    (``algorithms.py:268``): min-plus over the zero-weighted symmetrised
    structure, ``min_j (0 + label[j])`` over the neighbours j, to a
    fixed point in O(diameter) sweeps.

    Returns ``(n_components, labels)``, the int32 labels renumbered
    0..n_components-1 in the order of their smallest vertex."""
    from ..parallel import dist_csr as _dc

    op, n = _push_operator(csgraph, directed=False, unweighted=True,
                           zero_weights=True)
    dA = _shard_operator(op, mesh, layout)
    cap = _max_iters(n, max_iters)
    _counters.inc("graph.cc.runs")
    with _latency.timer("lat.graph.cc"), \
            _trace.span("graph.cc", n=n, layout=dA.layout) as sp:
        labels = _block(torch.arange(n, dtype=torch.int32), dA)
        it = 0
        while it < cap:
            relaxed = _dc.dist_spmv(dA, labels, semiring="min-plus")
            new = torch.minimum(labels, relaxed.to(labels.dtype))
            if not _fetch_any(new < labels, dA, "cc"):
                break
            it += 1
            labels = new
        _counters.inc("graph.cc.iters", it)
        if sp is not None:
            sp.set(iters=it)
    lab = _whole(labels, dA, n)
    if n == 0:
        return 0, lab
    _, relabeled = torch.unique(lab, return_inverse=True)
    return int(relabeled.max()) + 1, relabeled.to(torch.int32)


def _pagerank_operator(csgraph):
    """``(M, has_out_edges, n)``: the column-normalised transpose
    (M[v, u] = 1/outdeg(u) an edge u -> v) and the vertices with an
    out-edge."""
    from ..csgraph import _graph_edges

    rows, cols, _, n = _graph_edges(csgraph, True, True)
    # One edge per (row, col) before the degree count: the operator
    # keeps one entry per coordinate, so a multigraph's duplicates must
    # not inflate outdeg (its column sums would drop below 1 and rank
    # mass leak every iteration).
    uniq = torch.unique(rows * n + cols)
    rows, cols = uniq // max(n, 1), uniq % max(n, 1)
    outdeg = torch.bincount(rows, minlength=n).to(torch.float64)
    nz = outdeg > 0
    inv_out = torch.where(nz, 1.0 / torch.where(nz, outdeg, 1.0), 0.0)
    return _csr_from_edges(cols, rows, inv_out[rows], n), nz, n


def pagerank(csgraph, *, alpha: float = 0.85, tol: float = 1e-6,
             max_iters: int = 100, conv_test_iters: Optional[int] = None,
             mesh=None, layout=None):
    """PageRank by damped plus-times power iteration on the
    column-normalised transpose M (M[v, u] = 1/outdeg(u) an edge u -> v;
    ``algorithms.py:312``)::

        r <- alpha * (M r + dangling_mass / n) + (1 - alpha) / n

    The dangling mass is an inner product with the dangling indicator on
    the device (one all-reduce).  max |r_k - r_{k-cycle}| is fetched
    once every ``conv_test_iters`` iterations (default
    ``settings.graph_conv_iters``), which also makes the iteration count
    a multiple of the cycle.  Returns the (n,) ranks (summing to 1)."""
    from ..linalg import _host_fetch
    from ..parallel import dist_csr as _dc
    from ..settings import settings

    M, nz, n = _pagerank_operator(csgraph)
    if n == 0:
        return torch.zeros(0, dtype=torch.float64, device=M.device)
    dM = _shard_operator(M, mesh, layout)
    fdt = M.dtype
    cycle = int(conv_test_iters or settings.graph_conv_iters)
    group = dM.vector_group
    multi = dist.get_world_size(group) > 1
    r = _block(torch.full((n,), 1.0 / n, dtype=fdt), dM)
    dang = _block((~nz).to(fdt), dM)
    # Real rows only: the padding rows past n must stay 0, or the
    # teleport term would leak rank into them.
    mask = _block(torch.ones(n, dtype=fdt), dM)
    inv_n = 1.0 / n
    _counters.inc("graph.pagerank.runs")
    it = 0
    with _latency.timer("lat.graph.pagerank"), \
            _trace.span("graph.pagerank", n=n, layout=dM.layout) as sp:
        while it < max_iters:
            r_prev = r
            for _ in range(cycle):
                y = _dc.dist_spmv(dM, r)
                dm = torch.dot(dang, r)
                if multi:
                    dist.all_reduce(dm, group=group)
                r = mask * (alpha * (y + dm * inv_n) + (1.0 - alpha) * inv_n)
                it += 1
                if it >= max_iters:
                    break
            delta = (r - r_prev).abs().max().reshape(1)
            if multi:
                dist.all_reduce(delta, op=dist.ReduceOp.MAX, group=group)
            _counters.handle("transfer.host_sync.graph_pagerank").inc()
            if _host_fetch(delta)[0] < tol:
                break
        _counters.inc("graph.pagerank.iters", it)
        if sp is not None:
            sp.set(iters=it)
    return _whole(r, dM, n)
