"""The plain reference of the ``gmg`` preconditioner: one V-cycle of
geometric multigrid on a square 2-D grid, rebuilt from its definition.

The definition (the preconditioner's parameters in the traffic mix):

- ``gridop`` ``linear``: the restriction R takes coarse point (i, j) of
  an (m/2)^2 grid from fine points (2i + di, 2j + dj), di, dj in
  {-1, 0, 1}, with weights (2 - |di|)(2 - |dj|) / 16, points outside
  the fine grid left out; the prolongation P is its transpose;
- ``levels``: the fine operator and ``levels - 1`` coarse ones, each
  the Galerkin product A_(l+1) = R A_l P;
- ``smoother`` ``jacobi``: D_l the diagonal of A_l, and the weight
  w_l = (4/3) / lambda_l, lambda_l the Rayleigh quotient
  x . (A_l D_l^-1 x) after ``power_iters`` steps x <- A_l D_l^-1 x /
  |A_l D_l^-1 x| of power iteration from numpy's
  ``default_rng(7).random(n_l)``;
- the V-cycle at level l below the last: x = w D^-1 r, then
  x += P V_(l+1)(R (r - A x)), then x += w D^-1 (r - A x); at the last
  level x = w D^-1 r.

Plain PyTorch sparse tensors over the fine operator of the
configuration's own reference (``matrix()``); it imports nothing of
the program and takes nothing the program made.  With
``dtype=torch.bfloat16`` (the control) every operator and vector is
stored in bfloat16 between steps, the products computed in float32.
"""

from __future__ import annotations

import numpy as np
import torch

WEIGHTS = [(di, dj, (2 - abs(di)) * (2 - abs(dj)) / 16.0)
           for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def restriction(m: int, dtype, device) -> torch.Tensor:
    """R from an m x m grid to (m // 2) x (m // 2), sparse CSR."""
    mc = m // 2
    ij = torch.arange(mc * mc, dtype=torch.int64, device=device)
    ci, cj = ij // mc, ij % mc
    rows, cols, vals = [], [], []
    for di, dj, w in WEIGHTS:
        fi, fj = 2 * ci + di, 2 * cj + dj
        ok = (fi >= 0) & (fi < m) & (fj >= 0) & (fj < m)
        rows.append(ij[ok])
        cols.append(fi[ok] * m + fj[ok])
        vals.append(torch.full((int(ok.sum()),), w, dtype=dtype,
                               device=device))
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    return torch.sparse_coo_tensor(idx, torch.cat(vals),
                                   (mc * mc, m * m)).coalesce()


def diagonal(A: torch.Tensor) -> torch.Tensor:
    coo = A.to_sparse_coo().coalesce()
    i, j = coo.indices()
    on = i == j
    d = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    d[i[on]] = coo.values()[on]
    return d


class Preconditioner:
    """The hierarchy of ``op``'s fine matrix; ``apply(r, dtype)``."""

    def __init__(self, op, config: dict, params: dict):
        if (params["gridop"], params["smoother"]) != ("linear", "jacobi"):
            raise ValueError(f"no reference for {params!r}")
        grid = config["grid"]
        if len(grid) != 2 or grid[0] != grid[1]:
            raise ValueError("the V-cycle is defined on a square 2-D grid")
        self.params = params
        self.op = op
        self.m = int(grid[0])
        self.levels = {}

    def _hierarchy(self, dtype):
        """Per level ``(A, R, P, w, D^-1)`` in the working type, each
        stored in ``dtype``."""
        if dtype in self.levels:
            return self.levels[dtype]
        low = dtype != torch.float64
        work = torch.float32 if low else torch.float64

        def rnd(A):
            if not low:
                return A
            if A.layout == torch.strided:
                return A.to(dtype).to(work)
            return torch.sparse_csr_tensor(
                A.crow_indices(), A.col_indices(),
                A.values().to(dtype).to(work), A.shape)

        A = rnd(self.op.matrix().to(work))
        dev = A.device
        m = self.m
        out = []
        for level in range(int(self.params["levels"])):
            d_inv = rnd(1.0 / diagonal(A))
            x = torch.from_numpy(
                np.random.default_rng(7).random(A.shape[1])).to(dev, work)
            for _ in range(int(self.params["power_iters"])):
                x = A @ (d_inv * x)
                x = x / torch.linalg.vector_norm(x)
            w = (4.0 / 3.0) / float(torch.dot(x, A @ (d_inv * x)))
            if level == int(self.params["levels"]) - 1:
                out.append((A, None, None, w, d_inv))
                break
            R = restriction(m, work, dev)
            P = R.t().coalesce().to_sparse_csr()
            R = R.to_sparse_csr()
            out.append((A, R, P, w, d_inv))
            A = rnd((R @ A) @ P)
            m //= 2
        self.levels[dtype] = out
        return out

    def apply(self, r: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """``M r``, flat, float64."""
        low = dtype != torch.float64
        work = torch.float32 if low else torch.float64

        def rnd(t):
            return t.to(dtype).to(work) if low else t

        levels = self._hierarchy(dtype)

        def cycle(level, r):
            A, R, P, w, d_inv = levels[level]
            x = rnd(w * r * d_inv)
            if R is None:
                return x
            fine_r = rnd(r - rnd(A @ x))
            x = rnd(x + rnd(P @ cycle(level + 1, rnd(R @ fine_r))))
            return rnd(x + rnd(w * rnd(r - rnd(A @ x)) * d_inv))

        return cycle(0, rnd(r.to(work))).to(torch.float64)
