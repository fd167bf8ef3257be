"""The plain reference of the ``stencil`` operator family:
constant-coefficient stencils on a Dirichlet grid.

Everything here is rebuilt from a configuration's definition (its grid
and its stencil) in plain PyTorch; it imports nothing of the program
under test and takes nothing the program made.  ``operator(config,
seed, device)`` is the family's reference as the harness finds it by
the configuration's ``operator``: ``apply``, ``solve`` and ``matrix``.

A grid is a list of extents, slowest axis first; the unknown at grid
point ``(i_0, ..., i_{d-1})`` is row ``((i_0 g_1 + i_1) g_2 + ...)``,
as a row-major flattening gives it.  Two stencil shapes cover the
configurations:

- ``star``: ``center`` on the diagonal, ``neighbor`` at the 2d nearest
  points (the 5-point Poisson operator in 2-D);
- ``box``: ``center`` on the diagonal, ``neighbor`` at the other
  3^d - 1 points of the 3^d cube (HPCG's 27-point operator in 3-D).

Points outside the grid are zero (Dirichlet), so both operators are
diagonalised by the type-I discrete sine transform along every axis.
``solve`` uses that: the exact solution in float64, independent of any
iteration.  ``apply`` is the stencil by shifted adds.

The control (``apply`` and ``solve`` with ``dtype=torch.bfloat16``) is
the same computation one precision rung below the configurations'
float32: every array is stored in bfloat16 between steps (the FFT has
no bfloat16 kernel, so a transform's own arithmetic runs in float32 on
bfloat16 inputs and is rounded back).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

SHAPES = ("star", "box")


def offsets(stencil: dict, ndim: int):
    """The stencil's ``(offset vector, value)`` pairs, in ascending
    order of their flattened offset (the column order of a CSR row)."""
    shape = stencil["shape"]
    if shape not in SHAPES:
        raise ValueError(f"unknown stencil shape {shape!r}")
    out = []
    for flat in range(3 ** ndim):
        o = []
        for _ in range(ndim):
            o.append(flat % 3 - 1)
            flat //= 3
        o = tuple(reversed(o))
        nonzero = sum(1 for v in o if v)
        if nonzero == 0:
            out.append((o, float(stencil["center"])))
        elif shape == "box" or nonzero == 1:
            out.append((o, float(stencil["neighbor"])))
    return out


def nnz(grid: Sequence[int], stencil: dict) -> int:
    """Stored entries of the operator: for each stencil point, the grid
    points whose neighbour at that offset lies inside the grid."""
    total = 0
    for o, _ in offsets(stencil, len(grid)):
        total += math.prod(g - abs(v) for g, v in zip(grid, o))
    return total


def _neighbor_sum(X: torch.Tensor, dim: int) -> torch.Tensor:
    """``X[i-1] + X[i+1]`` along ``dim``, zero outside."""
    n = X.shape[dim]
    out = torch.zeros_like(X)
    if n > 1:
        out.narrow(dim, 1, n - 1).add_(X.narrow(dim, 0, n - 1))
        out.narrow(dim, 0, n - 1).add_(X.narrow(dim, 1, n - 1))
    return out


def apply(grid: Sequence[int], stencil: dict, x: torch.Tensor,
          dtype=torch.float64) -> torch.Tensor:
    """``A @ x`` for the stencil operator, computed in ``dtype`` (x is
    rounded to it first); flat, in ``dtype``."""
    c = float(stencil["center"])
    v = float(stencil["neighbor"])
    X = x.to(dtype).reshape(tuple(grid))
    if stencil["shape"] == "star":
        acc = X * c
        for dim in range(X.dim()):
            acc = acc + _neighbor_sum(X, dim) * v
        return acc.reshape(-1)
    if stencil["shape"] == "box":
        S = X
        for dim in range(X.dim()):
            S = S + _neighbor_sum(S, dim)
        return (X * (c - v) + S * v).reshape(-1)
    raise ValueError(f"unknown stencil shape {stencil['shape']!r}")


def eigenvalues(grid: Sequence[int], stencil: dict, dtype=torch.float64,
                device=None) -> torch.Tensor:
    """The operator's eigenvalues on the grid, indexed like the
    sine-transform coefficients: ``lambda[k_0, ..., k_{d-1}]``."""
    c = float(stencil["center"])
    v = float(stencil["neighbor"])
    cos = [torch.cos(torch.arange(1, g + 1, dtype=torch.float64,
                                  device=device) * (math.pi / (g + 1)))
           for g in grid]
    d = len(grid)

    def along(t, axis):
        shape = [1] * d
        shape[axis] = t.shape[0]
        return t.reshape(shape)

    if stencil["shape"] == "star":
        lam = torch.full(tuple(grid), c, dtype=torch.float64, device=device)
        for axis, cs in enumerate(cos):
            lam = lam + along(2.0 * v * cs, axis)
    elif stencil["shape"] == "box":
        prod = torch.ones(tuple(grid), dtype=torch.float64, device=device)
        for axis, cs in enumerate(cos):
            prod = prod * along(1.0 + 2.0 * cs, axis)
        lam = (c - v) + v * prod
    else:
        raise ValueError(f"unknown stencil shape {stencil['shape']!r}")
    return lam.to(dtype)


def dst1(X: torch.Tensor, dim: int) -> torch.Tensor:
    """Unnormalised type-I sine transform along ``dim``:
    ``Y[k] = sum_j X[j] sin(pi (j+1)(k+1) / (n+1))``, through a real FFT
    of the odd extension (float32 or float64)."""
    n = X.shape[dim]
    Xm = X.movedim(dim, -1)
    zero = torch.zeros(Xm.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    ext = torch.cat([zero, Xm, zero, -Xm.flip(-1)], dim=-1)
    Y = torch.fft.rfft(ext, dim=-1).imag[..., 1:n + 1] * -0.5
    return Y.movedim(-1, dim).contiguous()


def solve(grid: Sequence[int], stencil: dict, b: torch.Tensor,
          dtype=torch.float64) -> torch.Tensor:
    """The exact solution of ``A x = b`` by the sine transform; flat,
    float64.  ``dtype=torch.bfloat16`` is the control: every stage
    stored in bfloat16."""
    low = dtype not in (torch.float64, torch.float32)
    work = torch.float32 if low else dtype

    def rnd(t):
        return t.to(dtype).to(work) if low else t

    B = rnd(b.to(work)).reshape(tuple(grid))
    for dim in range(len(grid)):
        B = rnd(dst1(B, dim))
    B = rnd(B / rnd(eigenvalues(grid, stencil, work, b.device)))
    for dim in range(len(grid)):
        B = rnd(dst1(B, dim))
    scale = math.prod(2.0 / (g + 1) for g in grid)
    return rnd(B * scale).reshape(-1).to(torch.float64)


def matrix(grid: Sequence[int], stencil: dict, device=None,
           dtype=torch.float64) -> torch.Tensor:
    """The operator as a sparse CSR tensor, from its entries at every
    offset (coalesced from COO)."""
    n = math.prod(grid)
    row = torch.arange(n, dtype=torch.int64, device=device)
    coords = []
    rest = row
    for g in reversed(grid):
        coords.append(rest % g)
        rest = rest // g
    coords.reverse()
    rows, cols, vals = [], [], []
    for o, value in offsets(stencil, len(grid)):
        ok = torch.ones(n, dtype=torch.bool, device=device)
        shift = 0
        stride = 1
        for c, g, v in reversed(list(zip(coords, grid, o))):
            ok &= (c + v >= 0) & (c + v < g)
            shift += v * stride
            stride *= g
        r = row[ok]
        rows.append(r)
        cols.append(r + shift)
        vals.append(torch.full((r.numel(),), value, dtype=dtype,
                               device=device))
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n))
    return coo.coalesce().to_sparse_csr()


class Operator:
    """The reference of one configuration of the family."""

    def __init__(self, config: dict, device=None):
        self.grid = list(config["grid"])
        self.stencil = config["stencil"]
        self.device = device

    def apply(self, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        return apply(self.grid, self.stencil, x, dtype)

    def solve(self, b: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        return solve(self.grid, self.stencil, b, dtype)

    def matrix(self) -> torch.Tensor:
        return matrix(self.grid, self.stencil, self.device)


def operator(config: dict, seed: int, device=None) -> Operator:
    """A stencil has no random part: ``seed`` is not used."""
    return Operator(config, device)
