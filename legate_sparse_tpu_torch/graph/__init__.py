# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Graph analytics: the semiring SpMV and the algorithms built on it.

Counterpart of ``legate_sparse_tpu/graph/``.  Graph traversal is SpMV
over another semiring (the GraphBLAS observation):

- ``semiring`` — the closed catalog (``plus-times``, ``min-plus``,
  ``max-times``, ``or-and``);
- ``algorithms`` — BFS, SSSP (Bellman-Ford), connected components and
  PageRank as iterated semiring ``dist_spmv`` (every rank calls them
  with the same graph, as it calls ``shard_csr``);
- :func:`matvec` — the single-device semiring SpMV.

The products are ``ops/spmv.py``'s ``*_semiring_*`` (plain PyTorch: the
JAX package leaves them to XLA, outside any Pallas kernel), and the
distributed arm is ``parallel.dist_spmv(..., semiring=)``.
"""

from __future__ import annotations

from .semiring import (  # noqa: F401
    MAX_TIMES,
    MIN_PLUS,
    OR_AND,
    PLUS_TIMES,
    SEMIRINGS,
    Semiring,
    resolve,
)
from .algorithms import (  # noqa: F401
    bfs,
    connected_components,
    pagerank,
    sssp,
)


def matvec(A, x, semiring="plus-times", kernel=None):
    """Single-device semiring SpMV ``y = A (x)`` (``graph/__init__.py:46``).

    ``kernel`` picks the packed structure by its label:
    ``"semiring-csr"`` (the default: masked gather and row reduction
    over the row ids), ``"semiring-ell"`` or ``"semiring-sliced-ell"``
    (the matrix's ELL or sliced-ELL pack, which must exist).  The three
    give one result for a semiring whose add is min or max; under
    plus-times each is bit for bit its plus-times sibling."""
    from ..obs import counters as _counters
    from ..ops import spmv as _sp

    sr = resolve(semiring)
    _counters.inc("graph.matvec." + sr.name)
    label = kernel or "semiring-csr"
    if label == "semiring-ell":
        ell = A._get_ell()
        if ell is None:
            raise ValueError(
                "graph.matvec: kernel='semiring-ell' but the matrix has no "
                "ELL pack (padding budget exceeded?)")
        return _sp.ell_semiring_spmv(ell[0], ell[1], ell[2], x, sr.add,
                                     sr.mul)
    if label == "semiring-sliced-ell":
        bins = A._get_sliced_ell()
        if bins is None:
            raise ValueError(
                "graph.matvec: kernel='semiring-sliced-ell' but the matrix "
                "has no sliced-ELL pack (empty matrix?)")
        return _sp.sliced_ell_semiring_spmv(bins, x, A.shape[0], sr.add,
                                            sr.mul)
    if label != "semiring-csr":
        raise ValueError(f"graph.matvec: unknown kernel {label!r}")
    return _sp.csr_semiring_spmv_rowids_masked(
        A.data, A.indices, A._get_row_ids(), A.data.shape[0], x,
        A.shape[0], sr.add, sr.mul)
