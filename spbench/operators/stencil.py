"""``stencil``: constant-coefficient stencils on a Dirichlet grid, as
CSR arrays for the program, with the operator's size and work.

A configuration of this family gives ``grid`` (extents, slowest axis
first) and ``stencil`` (``shape`` ``star`` or ``box``, ``center``,
``neighbor``); ``reference/stencil.py`` defines the operator.

The arrays are built on the device from the stencil's arithmetic, one
stencil point at a time in column order, so each row comes out sorted
with no sort and no COO: for every grid point, the neighbour at each
offset is stored where it lies inside the grid.  They are what a user
of the program hands it (``data``, ``indices``, ``indptr``); what the
program derives from them is its own.
"""

from __future__ import annotations

import math

import torch

from ..reference.stencil import nnz as _nnz
from ..reference.stencil import offsets


def rows(config: dict) -> int:
    return math.prod(config["grid"])


def nnz(config: dict) -> int:
    """Stored entries, counted from the definition."""
    return _nnz(config["grid"], config["stencil"])


def assemble(config: dict, dtype: torch.dtype, device, seed: int) -> tuple:
    """``(data, indices, indptr)`` of the stencil operator on the
    configuration's grid: int32 column indices, int64 row pointers,
    values in ``dtype``.  A stencil has no random part: ``seed`` is
    not used."""
    grid = config["grid"]
    n = math.prod(grid)
    d = len(grid)
    row = torch.arange(n, dtype=torch.int64, device=device)
    coords = []
    rest = row
    for g in reversed(grid):
        coords.append(rest % g)
        rest = rest // g
    coords.reverse()
    strides = [math.prod(grid[a + 1:]) for a in range(d)]
    points = offsets(config["stencil"], d)

    def inside(o):
        ok = torch.ones(n, dtype=torch.bool, device=device)
        for c, g, v in zip(coords, grid, o):
            if v:
                ok &= (c + v >= 0) & (c + v < g)
        return ok

    counts = torch.zeros(n, dtype=torch.int64, device=device)
    for o, _ in points:
        counts += inside(o)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    total = int(indptr[-1])
    indices = torch.empty(total, dtype=torch.int32, device=device)
    data = torch.empty(total, dtype=dtype, device=device)
    slot = indptr[:-1].clone()
    for o, value in points:
        ok = inside(o)
        pos = slot[ok]
        indices[pos] = (row[ok] + sum(v * s for v, s in zip(o, strides))
                        ).to(torch.int32)
        data[pos] = value
        slot += ok
    return data, indices, indptr
