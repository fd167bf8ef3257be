# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""scipy.sparse.csgraph on the graph's device, and scipy's other csgraph
names as host fallbacks that take this package's arrays.

Mirrors ``legate_sparse_tpu/csgraph.py``: ``connected_components``
(``:113``, weak connectivity by min-label propagation
``_label_propagation`` ``:91``), ``laplacian`` (``:147``),
``_graph_edges`` (``:190``), ``_relax_all`` (``:215``, every source at
once, one min-plus semiring SpMM a sweep), ``_predecessors``
(``:261``), ``_resolve_indices`` (``:277``), ``_minplus_paths``
(``:292``), ``bellman_ford``, ``dijkstra``, ``johnson``,
``floyd_warshall`` (dense, ``:405``), ``shortest_path`` (``:445``),
``_boruvka`` and ``minimum_spanning_tree`` (``:471-600``, the strict
(weight, stored index) order, so the edge set is a function of the
input) and the module ``__getattr__`` (``:604``).

The JAX package runs each propagation or relaxation as one
``lax.while_loop``; here each is a Python loop over device tensors that
fetches one flag a sweep (``changed``).  The min and max reductions are
``scatter_reduce`` from the identity, which do not depend on order, so
labels, distances, predecessors and MST edge sets are bit for bit the
JAX package's.  Array results are tensors on the graph's device (the
JAX package returns numpy arrays); counts are Python ints.  Directed
strong connectivity, ``laplacian(form=...)`` other than ``"array"``,
and every other scipy csgraph name run scipy on the host.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

# scipy's exception class, so callers' except clauses work unchanged.
from scipy.sparse.csgraph import NegativeCycleError

from .ops import spmv as _spmv
from .runtime import default_float
from .types import index_dtype

__all__ = [
    "connected_components", "laplacian", "shortest_path",
    "bellman_ford", "dijkstra", "johnson", "floyd_warshall",
    "minimum_spanning_tree", "NegativeCycleError",
]

_UNREACHABLE = -9999  # scipy's predecessor/source sentinel


def _as_package_csr(graph):
    from .csr import _is_scipy_sparse, csr_array
    from .runtime import resolve_device
    from .utils import as_tensor

    if _is_scipy_sparse(graph):
        return csr_array(graph)
    if hasattr(graph, "tocsr") and hasattr(graph, "nnz"):
        return graph.tocsr()
    if not isinstance(graph, torch.Tensor):
        graph = as_tensor(graph, resolve_device(None))
    return csr_array(graph)


def _narrow_indices(x):
    """scipy.sparse.csgraph's Cython kernels are int32-indexed: narrow
    int64 index arrays when they fit."""
    import scipy.sparse as _sp

    if (_sp.issparse(x) and x.format == "csr"
            and x.indices.dtype == np.int64
            and x.shape[1] <= np.iinfo(np.int32).max
            and x.nnz <= np.iinfo(np.int32).max):
        return _sp.csr_array(
            (x.data, x.indices.astype(np.int32),
             x.indptr.astype(np.int32)), shape=x.shape)
    return x


def _host_fallback(name):
    """scipy's csgraph ``name`` through ``coverage.scipy_fallback``, the
    operands converted and their indices narrowed on the way in."""
    import functools

    import scipy.sparse.csgraph as _csg

    from .coverage import _to_scipy, scipy_fallback

    inner = scipy_fallback(getattr(_csg, name), f"csgraph.{name}")

    @functools.wraps(inner)
    def wrapper(*args, **kwargs):
        args = tuple(_narrow_indices(_to_scipy(a)) for a in args)
        kwargs = {k: _narrow_indices(_to_scipy(v))
                  for k, v in kwargs.items()}
        return inner(*args, **kwargs)

    return wrapper


def _changed(flag: torch.Tensor) -> bool:
    """The one host fetch of a sweep."""
    return bool(flag.item())


def _scatter_min(out, index, src):
    return out.scatter_reduce(0, index, src, "amin")


def _label_propagation(rows, cols, n: int):
    """Min-label propagation over an undirected edge list: per-component
    minimum node ids after O(diameter) sweeps."""
    labels = torch.arange(n, dtype=index_dtype(), device=rows.device)
    while True:
        new = _scatter_min(labels, rows, labels[cols])
        new = _scatter_min(new, cols, new[rows])
        if not _changed(torch.any(new != labels)):
            return new
        labels = new


def connected_components(csgraph, directed=True, connection="weak",
                         return_labels=True):
    """Number of connected components and the labels (scipy's
    signature).  Undirected graphs and directed 'weak' run on the device
    (weak connectivity ignores direction: both are the same symmetrised
    propagation); directed 'strong' runs scipy on the host (Tarjan is
    sequential)."""
    connection = str(connection).lower()
    if connection not in ("weak", "strong"):
        raise ValueError("connection must be 'weak' or 'strong'")
    if directed and connection == "strong":
        return _host_fallback("connected_components")(
            csgraph, directed=directed, connection=connection,
            return_labels=return_labels)
    A = _as_package_csr(csgraph)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("graph must be square")
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=A.device)
        return (0, empty) if return_labels else 0
    raw = _label_propagation(A._get_row_ids().to(torch.int64),
                             A._indices.to(torch.int64), n)
    # scipy numbers components 0..k-1 in order of first appearance.  The
    # raw labels are component-minimum node ids, whose first occurrence
    # is the id itself, so sorted order is first-appearance order.
    uniq, inverse = torch.unique(raw, sorted=True, return_inverse=True)
    count = int(uniq.shape[0])
    return (count, inverse.to(torch.int32)) if return_labels else count


def laplacian(csgraph, normed=False, return_diag=False,
              use_out_degree=False, *, copy=True, form="array",
              dtype=None, symmetrized=False):
    """Graph Laplacian L = D - A (scipy's signature) from one degree
    reduction on the device; ``form`` other than ``"array"`` runs scipy
    on the host.  The diagonal (or, ``normed``, the scaling) comes back
    as a tensor."""
    if form != "array":
        return _host_fallback("laplacian")(
            csgraph, normed=normed, return_diag=return_diag,
            use_out_degree=use_out_degree, copy=copy, form=form,
            dtype=dtype, symmetrized=symmetrized)
    A = _as_package_csr(csgraph)
    if A.shape[0] != A.shape[1]:
        raise ValueError("csgraph must be a square matrix or array")
    if dtype is not None:
        A = A.astype(dtype)
    elif normed and not (A.dtype.is_floating_point or A.dtype.is_complex):
        A = A.astype(torch.float64)   # int input; complex is preserved
    if symmetrized:
        A = A + A.T.conj().tocsr()    # scipy: m += m.T.conj()
    # scipy (``_laplacian_sparse``): degrees exclude self-loops, and the
    # diagonal is overwritten.
    axis = 1 if use_out_degree else 0
    d = A.sum(axis=axis).reshape(-1) - A.diagonal()
    if not normed:
        L = A._with_data(-A._data)
        L.setdiag(d)
        return (L, d) if return_diag else L
    isolated = d == 0
    w = torch.where(isolated, 1.0, torch.sqrt(torch.where(isolated, 1.0, d)))
    L = A._with_data(-A._data / (w[A._get_row_ids().to(torch.int64)]
                                 * w[A._indices.to(torch.int64)]))
    L.setdiag(1.0 - isolated.to(w.dtype))
    return (L, w) if return_diag else L


# ---------------------------------------------------------------------------
# Shortest paths: min-plus relaxation (all sources at once) + Floyd-Warshall.
# ---------------------------------------------------------------------------

def _graph_edges(csgraph, directed, unweighted):
    """Edge list (rows, cols, w, n) of the traversal graph.  Stored zeros
    are edges (scipy); ``directed=False`` appends the reversed edges, and
    the min of the two directions comes out of the relaxation."""
    A = _as_package_csr(csgraph)
    if A.shape[0] != A.shape[1]:
        raise ValueError("graph must be a square matrix or array")
    n = A.shape[0]
    rows = A._get_row_ids().to(torch.int64)
    cols = A._indices.to(torch.int64)
    if unweighted:
        w = torch.ones(rows.shape, dtype=default_float, device=A.device)
    else:
        w = A._data.to(default_float)
    if not directed:
        rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
        w = torch.cat([w, w])
    return rows, cols, w, n


def _relax_all(rows, cols, w, sources, n: int):
    """Bellman-Ford for every source at once: a sweep is one min-plus
    semiring SpMM (``ops/spmv.py csr_semiring_spmm_rowids_masked``) of
    the transposed edge operator against the (n, S) tentative
    distances.  At most n sweeps; one that still improves after n - 1
    can only mean a reachable negative cycle.  Returns (dist (S, n),
    negative-cycle flag)."""
    S = sources.shape[0]
    # Edges sorted by head: the heads are the segment ids, the tails the
    # gather.
    order = torch.argsort(cols, stable=True)
    heads, tails, we = cols[order], rows[order], w[order]
    nnz = we.shape[0]
    dist = torch.full((n, S), torch.inf, dtype=w.dtype, device=w.device)
    dist[sources, torch.arange(S, device=w.device)] = 0.0

    def sweep(d):
        relaxed = _spmv.csr_semiring_spmm_rowids_masked(
            we, tails, heads, nnz, d, n, "min", "plus")
        return torch.minimum(d, relaxed)

    for _ in range(n):
        new = sweep(dist)
        improved = torch.any(new < dist)
        dist = new
        if not _changed(improved):
            break
    extra = sweep(dist)
    return dist.T, torch.any(extra < dist)


def _predecessors(rows, cols, w, dist, sources, n: int):
    """Predecessors consistent with converged distances: node j's
    predecessor (per source) is the smallest-indexed edge tail u with
    dist[u] + w == dist[j].  One gather and one scatter-min."""
    S = dist.shape[0]
    tail = dist[:, rows]
    # inf + w == inf would mark edges between unreachable nodes tight;
    # scipy keeps -9999 there.
    tight = torch.isfinite(tail) & (tail + w[None, :] == dist[:, cols])
    cand = torch.where(tight, rows[None, :], n)
    pred = torch.full((S, n), n, dtype=rows.dtype, device=rows.device)
    pred = pred.scatter_reduce(1, cols[None, :].expand(S, -1), cand, "amin")
    pred = torch.where(pred == n, _UNREACHABLE, pred)
    pred[torch.arange(S, device=rows.device), sources] = _UNREACHABLE
    return pred


def _resolve_indices(indices, n):
    """(sources, squeeze?) per scipy: None gives all nodes, a scalar a
    1-D result, negatives wrap, out of range raises."""
    if indices is None:
        return np.arange(n, dtype=np.int64), False
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    idx = np.asarray(indices, dtype=np.int64)
    scalar = idx.ndim == 0
    idx = np.atleast_1d(idx)
    if idx.size and (np.any(idx < -n) or np.any(idx >= n)):
        raise ValueError("indices out of range 0...N")
    return idx % max(n, 1), scalar


def _minplus_paths(csgraph, directed, indices, return_predecessors,
                   unweighted, limit=None, edges=None):
    rows, cols, w, n = (edges if edges is not None
                        else _graph_edges(csgraph, directed, unweighted))
    dev = w.device
    src, scalar = _resolve_indices(indices, n)
    if n == 0 or src.size == 0:
        dist = torch.zeros((src.size, n), dtype=torch.float64, device=dev)
        pred = torch.full((src.size, n), _UNREACHABLE, dtype=torch.int32,
                          device=dev)
    else:
        tsrc = torch.as_tensor(src, device=dev)
        dist, neg = _relax_all(rows, cols, w, tsrc, n)
        if _changed(neg):
            raise NegativeCycleError("Negative cycle detected on the graph")
        if return_predecessors:
            pred = _predecessors(rows, cols, w, dist, tsrc, n).to(
                torch.int32)
        dist = dist.to(torch.float64)
    if limit is not None and limit != np.inf:
        # A prefix of a within-limit path is within the limit for
        # non-negative weights: filtering afterwards equals scipy's
        # cutoff in the search.
        over = dist > limit
        dist = torch.where(over, torch.inf, dist)
        if return_predecessors:
            pred = torch.where(over, _UNREACHABLE, pred).to(torch.int32)
    if scalar:
        dist = dist[0]
        if return_predecessors:
            pred = pred[0]
    return (dist, pred) if return_predecessors else dist


def bellman_ford(csgraph, directed=True, indices=None,
                 return_predecessors=False, unweighted=False,
                 overwrite=False):
    """Bellman-Ford shortest paths (scipy's signature): min-plus edge
    relaxation for every source at once.  Raises
    :class:`NegativeCycleError` as scipy does."""
    return _minplus_paths(csgraph, directed, indices,
                          return_predecessors, unweighted)


def dijkstra(csgraph, directed=True, indices=None,
             return_predecessors=False, unweighted=False,
             limit=np.inf, min_only=False):
    """Dijkstra-compatible shortest paths (scipy's signature).  A binary
    heap is sequential; the min-plus relaxation gives the same distances
    and stays exact under negative weights (scipy's dijkstra only warns
    there; the warning is kept).  On a reachable negative cycle this
    raises :class:`NegativeCycleError`, where scipy's dijkstra returns
    inaccurate finite values."""
    edges = _graph_edges(csgraph, directed, unweighted)
    w_ = edges[2]
    if w_.numel() and _changed(torch.any(w_ < 0)):
        warnings.warn("Graph has negative weights: dijkstra will give "
                      "inaccurate results if the graph contains "
                      "negative cycles. Consider johnson or "
                      "bellman_ford.", UserWarning, stacklevel=2)
    res = _minplus_paths(csgraph, directed, indices,
                         return_predecessors=return_predecessors,
                         unweighted=unweighted, limit=limit, edges=edges)
    if not min_only:
        return res
    # min_only: the best source per node; scipy returns (dist,
    # predecessors, sources).
    dist, pred = res if return_predecessors else (res, None)
    dist2 = torch.atleast_2d(dist)
    src, _ = _resolve_indices(indices, dist2.shape[1])
    win = torch.argmin(dist2, dim=0)
    ar = torch.arange(dist2.shape[1], device=dist2.device)
    best = dist2[win, ar]
    tsrc = torch.as_tensor(src, device=dist2.device)
    sources = torch.where(torch.isinf(best), _UNREACHABLE,
                          tsrc[win]).to(torch.int32)
    if not return_predecessors:
        return best
    return best, torch.atleast_2d(pred)[win, ar], sources


def johnson(csgraph, directed=True, indices=None,
            return_predecessors=False, unweighted=False):
    """Johnson's algorithm (scipy's signature).  Its point is to make
    negative weights safe for a heap; the min-plus relaxation already
    is, so this is :func:`bellman_ford`'s kernel."""
    return _minplus_paths(csgraph, directed, indices,
                          return_predecessors, unweighted)


def _fw_kernel(dist, pred, n: int, want_pred: bool):
    """The k-loop: rank-1 min-plus updates of the dense (n, n)
    distances."""
    for k in range(n):
        via = dist[:, k][:, None] + dist[k, :][None, :]
        better = via < dist
        dist = torch.where(better, via, dist)
        if want_pred:
            pred = torch.where(better, pred[k, :][None, :], pred)
    return dist, pred


def floyd_warshall(csgraph, directed=True, return_predecessors=False,
                   unweighted=False, overwrite=False):
    """Floyd-Warshall all-pairs shortest paths (scipy's signature) on
    the dense (n, n) distances on the device."""
    rows, cols, w, n = _graph_edges(csgraph, directed, unweighted)
    dev = w.device
    if n == 0:
        dist = torch.zeros((0, 0), dtype=torch.float64, device=dev)
        return ((dist, torch.zeros((0, 0), dtype=torch.int32, device=dev))
                if return_predecessors else dist)
    dense = torch.full((n * n,), torch.inf, dtype=w.dtype, device=dev)
    dense = _scatter_min(dense, rows * n + cols, w).reshape(n, n)
    # Self-loops can only lower a node's distance to itself below 0.
    ar = torch.arange(n, device=dev)
    dense[ar, ar] = torch.clamp_max(torch.diagonal(dense), 0.0)
    if return_predecessors:
        pred0 = torch.where(
            torch.isfinite(dense) & (ar[:, None] != ar[None, :]),
            ar.to(torch.int32)[:, None], _UNREACHABLE).to(torch.int32)
    else:
        pred0 = None
    dist, pred = _fw_kernel(dense, pred0, n, return_predecessors)
    if _changed(torch.any(torch.diagonal(dist) < 0)):
        raise NegativeCycleError("Negative cycle detected on the graph")
    dist = dist.to(torch.float64)
    return (dist, pred) if return_predecessors else dist


def shortest_path(csgraph, method="auto", directed=True,
                  return_predecessors=False, unweighted=False,
                  overwrite=False, indices=None):
    """Front end of ``scipy.sparse.csgraph.shortest_path``: 'FW' runs
    the dense kernel; 'D', 'BF', 'J' and 'auto' the min-plus relaxation
    (right for every weight sign, so 'auto' needs no heuristics)."""
    if method == "FW":
        if indices is not None:
            raise ValueError("Cannot specify indices with method == 'FW'")
        return floyd_warshall(csgraph, directed=directed,
                              return_predecessors=return_predecessors,
                              unweighted=unweighted, overwrite=overwrite)
    if method not in ("auto", "D", "BF", "J"):
        raise ValueError(f"unrecognized method '{method}'")
    return _minplus_paths(csgraph, directed, indices,
                          return_predecessors, unweighted)


# ---------------------------------------------------------------------------
# Minimum spanning tree: Boruvka rounds.
# ---------------------------------------------------------------------------

def _boruvka(rows, cols, w, n: int):
    """Boruvka MST over the stored (directed) edge list, taken as
    undirected.  Each round every component scatter-mins its cheapest
    outgoing edge under the strict total order (weight, stored index),
    i.e. lowest (weight, row, col) in CSR order, so ties never depend
    on scatter order and the edge set is a function of the input.
    Mutual picks are dropped on the larger component id, and
    components merge by min-label propagation with pointer jumping.
    Returns the in-tree mask over the stored edges."""
    dev = rows.device
    E = rows.shape[0]
    idt = index_dtype()
    eidx = torch.arange(E, dtype=idt, device=dev)
    comp0 = torch.arange(n, dtype=idt, device=dev)
    in_tree = torch.zeros((E,), dtype=torch.bool, device=dev)
    big_w = torch.tensor(torch.inf, dtype=w.dtype, device=dev)
    pad = torch.full((1,), n, dtype=idt, device=dev)
    comp = comp0
    while True:
        cu, cv = comp[rows], comp[cols]
        cross = cu != cv
        if not _changed(torch.any(cross)):
            return in_tree
        Wc = torch.where(cross, w, big_w)
        # The cheapest cross edge per component (either endpoint side).
        best_w = torch.full((n,), torch.inf, dtype=w.dtype, device=dev)
        best_w = _scatter_min(_scatter_min(best_w, cu, Wc), cv, Wc)
        tie_u = cross & (Wc == best_w[cu])
        tie_v = cross & (Wc == best_w[cv])
        best_e = torch.full((n,), E, dtype=idt, device=dev)
        best_e = _scatter_min(best_e, cu, torch.where(tie_u, eidx, E))
        best_e = _scatter_min(best_e, cv, torch.where(tie_v, eidx, E))
        has = best_e < E
        be = torch.clamp_max(best_e, E - 1)
        # Mutual picks: components c and p chose edges over the same
        # unordered pair {c, p}; keep only the pick of min(c, p).
        ecu, ecv = comp[rows[be]], comp[cols[be]]
        partner = torch.where(ecu == comp0, ecv, ecu)
        pe = torch.clamp_max(best_e[torch.clamp(partner, 0, n - 1)], E - 1)
        p_cu, p_cv = comp[rows[pe]], comp[cols[pe]]
        mutual = ((torch.minimum(p_cu, p_cv) == torch.minimum(ecu, ecv))
                  & (torch.maximum(p_cu, p_cv) == torch.maximum(ecu, ecv)))
        keep = has & ~(mutual & (partner < comp0))
        sel = torch.zeros((E + 1,), dtype=torch.bool, device=dev)
        sel[torch.where(keep, be, E)] = True
        sel = sel[:E]
        in_tree = in_tree | sel
        # Merge: min-label propagation over the selected edges (index n,
        # the pad slot, takes the unselected ones and is dropped), with
        # one pointer jump a sweep for long chains.
        r_i = torch.where(sel, rows, n)
        c_i = torch.where(sel, cols, n)
        lab = comp
        while True:
            lab_pad = torch.cat([lab, pad])
            # Hook at the class labels of the endpoints, so the class
            # root learns the merged min and the pointer jump flattens
            # the whole class in one sweep.
            lu, lv = lab_pad[r_i], lab_pad[c_i]
            new = _scatter_min(lab_pad, lu, lv)
            new = _scatter_min(new, lv, new[lu])
            new = _scatter_min(new, r_i, new[c_i])
            new = _scatter_min(new, c_i, new[r_i])[:n]
            new = torch.minimum(new, new[torch.clamp(new, 0, n - 1)])
            done = not _changed(torch.any(new != lab))
            lab = new
            if done:
                break
        comp = lab


def minimum_spanning_tree(csgraph, overwrite=False):
    """Minimum spanning tree or forest (scipy's signature and output: a
    CSR holding each chosen edge at its stored position).  Boruvka
    rounds on the device; with distinct weights the tree is unique and
    equals scipy's Kruskal, and ties break by the lowest stored (weight,
    row, col), so scipy's tie-breaks may differ edge by edge while the
    total weight agrees.  As scipy: the values are float64 whatever the
    input, and a chosen zero-weight edge is dropped from the stored
    structure."""
    from .csr import csr_array

    A = _as_package_csr(csgraph)
    if A.shape[0] != A.shape[1]:
        raise ValueError("graph must be a square matrix or array")
    n = A.shape[0]
    dev = A.device
    if n == 0 or A.nnz == 0:
        return csr_array(
            (torch.zeros(0, dtype=torch.float64, device=dev),
             torch.zeros(0, dtype=torch.int64, device=dev),
             torch.zeros(n + 1, dtype=torch.int64, device=dev)),
            shape=(n, n))
    rows = A._get_row_ids().to(index_dtype())
    cols = A._indices.to(index_dtype())
    in_tree = _boruvka(rows, cols, A._data.to(default_float), n)
    v = A._data[in_tree].to(torch.float64)
    keep = v != 0                      # scipy drops chosen zero edges
    r = rows[in_tree][keep]
    c = cols[in_tree][keep]
    v = v[keep]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    return csr_array((v, c, indptr), shape=(n, n))


def __getattr__(name):
    import scipy.sparse.csgraph as _csg

    try:
        if name.startswith("_"):       # scipy's module internals stay its own
            raise AttributeError(name)
        value = getattr(_csg, name)
    except AttributeError:
        raise AttributeError(
            f"module 'legate_sparse_tpu_torch.csgraph' has no attribute "
            f"{name!r}") from None
    if callable(value) and not isinstance(value, type):
        value = _host_fallback(name)
    globals()[name] = value            # one wrapper, a stable identity
    return value
