"""``kronecker``: the weighted adjacency matrix of a Graph500 Kronecker
graph, as CSR arrays for the program, with the operator's size and
work.

A configuration of this family gives ``scale``, ``edge_factor``,
``initiator`` and ``graph_seed``; ``reference/kronecker.py`` defines
the graph and draws its edges, chunk by chunk, on the device.  This
file turns the edge list into what a graph user hands the program:
self-loops dropped, each edge stored both ways, the entries sorted by
(row, column) and duplicates summed (in float64, then rounded to the
value type), as ``data``, int32 ``indices`` and int64 ``indptr``.
Unlike a stencil's, the structure is read, not computed: the least
bytes of a product count the column indices and the row offsets.

The sort runs over one slice of the rows at a time (``PART`` entries
or so each), so its temporaries stay a fraction of the matrix.
"""

from __future__ import annotations

import torch

from ..core.work import VALUE_BYTES
from ..reference import kronecker as _graph

# Stored entries (both directions, before duplicates are summed) that
# one slice of the rows holds, about: the slices are a power of two.
PART = 1 << 26


def rows(config: dict) -> int:
    return _graph.vertices(config)


def nnz(config: dict) -> int:
    """Stored entries: the configuration's count, measured once on the
    card where the graph is drawn, or (in tests, where it has none)
    counted from the edge list on the CPU."""
    if "nnz" in config:
        return int(config["nnz"])
    return _graph.stored_entries(config)


def spmv_bytes(config: dict) -> int:
    """Least bytes of ``y = A @ x``: each stored value and its int32
    column read once, ``rows + 1`` 4-byte row offsets read once, x read
    once and y written once."""
    w = VALUE_BYTES[config["dtype"]]
    n = rows(config)
    return nnz(config) * (w + 4) + (n + 1) * 4 + 2 * n * w


def _slices(config: dict) -> int:
    """Row slices of the sort: a power of two, at most the rows."""
    want = max(1, (2 * _graph.edges(config)) // PART)
    return min(1 << (want.bit_length() - 1), rows(config))


def assemble(config: dict, dtype: torch.dtype, device, seed: int) -> tuple:
    """``(data, indices, indptr)`` of the graph's symmetric weighted
    adjacency matrix on ``device``.  The graph is fixed by the
    configuration's ``graph_seed``; ``seed`` is not used.  Where the
    configuration states ``nnz``, the count is held to it."""
    scale = int(config["scale"])
    n = rows(config)
    op = _graph.Operator(config, device)
    parts = list(zip(*((i.to(torch.int32), j.to(torch.int32), w)
                       for i, j, w in op.edges())))
    del op
    src, dst, w = (torch.cat(p) for p in parts)
    del parts
    slices = _slices(config)
    shift = scale - (slices.bit_length() - 1)
    per = n // slices
    cols, vals, counts = [], [], []
    for s in range(slices):
        fwd = (src >> shift) == s
        bwd = (dst >> shift) == s
        row = torch.cat([src[fwd], dst[bwd]]).to(torch.int64)
        col = torch.cat([dst[fwd], src[bwd]]).to(torch.int64)
        val = torch.cat([w[fwd], w[bwd]])
        del fwd, bwd
        key, order = torch.sort((row << scale) | col)
        del row, col
        key, inverse = torch.unique_consecutive(key, return_inverse=True)
        # Float32 weights from torch.rand are multiples of 2^-24 below
        # 1: their float64 sum is exact in any order.
        summed = torch.zeros(key.shape[0], dtype=torch.float64,
                             device=key.device).index_add_(
            0, inverse, val[order].to(torch.float64))
        del order, inverse, val
        cols.append((key & (n - 1)).to(torch.int32))
        vals.append(summed.to(dtype))
        counts.append(torch.bincount((key >> scale) - s * per,
                                     minlength=per))
        del key, summed
    del src, dst, w
    indices = torch.cat(cols)
    del cols
    data = torch.cat(vals)
    del vals
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=indices.device)
    torch.cumsum(torch.cat(counts), 0, out=indptr[1:])
    if "nnz" in config and int(indices.shape[0]) != int(config["nnz"]):
        raise AssertionError(
            f"kronecker: {int(indices.shape[0])} stored entries, the "
            f"configuration states {int(config['nnz'])}")
    return data, indices, indptr
