# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Distributed geometric multigrid V-cycle, a preconditioner for
``dist_cg``.

Counterpart of ``legate_sparse_tpu/parallel/dist_gmg.py``: ``DistGMG``
(``:109-224``), the host-built restrictions ``_injection_csr``/
``_linear_csr`` (``:37``, ``:57``) and the spectral-radius estimate
``_dist_max_eigenvalue`` (``:92``).  Weighted-Jacobi smoothing,
injection or full-weighting transfers and Galerkin coarse operators
``R @ (A @ P)`` by ``dist_spgemm``, every level a row-block
``DistCSR``.  ``cycle`` maps this rank's block of a residual to its
block of the correction: the ``M`` contract of ``dist_cg``.

The transfers are built on the host with scipy (O(coarse) entries,
once), then sharded.  A rectangular R (coarse x fine) shards its rows
as the coarse operator does and takes its x by the all-gather, whose
blocks are the fine operator's row blocks, so its columns line up with
the fine vector's blocks (and P's with the coarse one's).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..obs import comm as _comm
from ..obs import trace as _trace
from ..types import to_numpy_dtype
from .dist_csr import (
    DistCSR, _local_rows, dist_diagonal, dist_spmv, mesh_device, shard_csr,
    spmv_comm_volumes,
)
from .dist_spgemm import dist_spgemm


def _injection_csr(fine_dim: int):
    """Injection restriction as host scipy CSR (``dist_gmg.py:37``)."""
    import scipy.sparse as sp

    fine_shape = (int(np.sqrt(fine_dim)),) * 2
    coarse_shape = (fine_shape[0] // 2, fine_shape[1] // 2)
    coarse_dim = int(np.prod(coarse_shape))
    ij = np.arange(coarse_dim, dtype=np.int64)
    i = ij // coarse_shape[1]
    j = ij % coarse_shape[1]
    cols = 2 * i * fine_shape[1] + 2 * j
    indptr = np.arange(coarse_dim + 1, dtype=np.int64)
    vals = np.ones(coarse_dim, dtype=np.float64)
    return (sp.csr_matrix((vals, cols, indptr), shape=(coarse_dim, fine_dim)),
            coarse_dim)


def _linear_csr(fine_dim: int):
    """Full-weighting 9-point restriction (``dist_gmg.py:57``)."""
    import scipy.sparse as sp

    fine_shape = (int(np.sqrt(fine_dim)),) * 2
    coarse_shape = (fine_shape[0] // 2, fine_shape[1] // 2)
    coarse_dim = int(np.prod(coarse_shape))
    ij = np.arange(coarse_dim, dtype=np.int64)
    ci = ij // coarse_shape[1]
    cj = ij % coarse_shape[1]
    rows, cols, vals = [], [], []
    for di, dj, w in ((-1, -1, 1 / 16), (-1, 0, 2 / 16), (-1, 1, 1 / 16),
                      (0, -1, 2 / 16), (0, 0, 4 / 16), (0, 1, 2 / 16),
                      (1, -1, 1 / 16), (1, 0, 2 / 16), (1, 1, 1 / 16)):
        fi = 2 * ci + di
        fj = 2 * cj + dj
        ok = ((fi >= 0) & (fi < fine_shape[0]) & (fj >= 0)
              & (fj < fine_shape[1]))
        rows.append(ij[ok])
        cols.append(fi[ok] * fine_shape[1] + fj[ok])
        vals.append(np.full(int(ok.sum()), w))
    R = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(coarse_dim, fine_dim))
    return R, coarse_dim


_RESTRICTIONS = {"injection": _injection_csr, "linear": _linear_csr}


def _dist_max_eigenvalue(A: DistCSR, d_inv: torch.Tensor,
                         iters: int = 1) -> float:
    """Spectral radius of A D^-1 by power iteration from
    ``default_rng(7)`` (``dist_gmg.py:92``); the norm and the Rayleigh
    quotient are all-reduced over the vector group."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random(A.shape[1]).astype(
        to_numpy_dtype(A.dtype))).to(A.device, A.dtype)
    x = _local_rows(x, A.local_len, A.shard, A.rows_padded)

    def mv(v):
        return dist_spmv(A, d_inv * v)

    def dot(u, v):
        t = torch.vdot(u, v)
        dist.all_reduce(t, group=A.vector_group)
        return t

    for _ in range(iters):
        y = mv(x)
        x = y / torch.sqrt(dot(y, y))
    return float(dot(x, mv(x)))


class DistGMG:
    """Distributed GMG hierarchy and V-cycle (``dist_gmg.py:109``).

    ``A`` is a 1d-row ``DistCSR`` or a ``csr_array`` (sharded onto
    ``mesh``).  ``levels`` counts grid levels, the coarsest being
    ``levels - 1``.  ``cycle`` maps this rank's block of a padded
    residual to its block of the correction; pass it as ``M`` to
    ``dist_cg``.  Building the hierarchy is a collective."""

    def __init__(self, A, levels: int, mesh=None, gridop: str = "injection",
                 omega: float = 4.0 / 3.0, power_iters: int = 1):
        from ..csr import csr_array

        if not isinstance(A, DistCSR):
            A = shard_csr(A, mesh=mesh)
        self.A = A
        self.levels = levels
        restrict = _RESTRICTIONS[gridop]
        self.operators: List[Tuple[DistCSR, DistCSR, DistCSR]] = []
        self.level_params: List[Tuple[float, torch.Tensor]] = []
        dim = A.shape[0]
        cur = A
        dev = mesh_device(A.mesh)
        np_dtype = to_numpy_dtype(cur.dtype)
        self._append_params(cur, omega, power_iters)
        for _ in range(levels - 1):
            R_sp, dim = restrict(dim)
            # The transfers take the system's dtype.
            R_sp = R_sp.astype(np_dtype)
            P_sp = R_sp.T.tocsr()
            dR = shard_csr(csr_array(R_sp, device=dev).astype(cur.dtype),
                           mesh=cur.mesh)
            dP = shard_csr(csr_array(P_sp, device=dev).astype(cur.dtype),
                           mesh=cur.mesh)
            coarse = dist_spgemm(dR, dist_spgemm(cur, dP))
            self.operators.append((dR, coarse, dP))
            self._append_params(coarse, omega, power_iters)
            cur = coarse
        self.cycle_comm_volumes = self._cycle_comm_volumes()
        self.cycle_comm_bytes = sum(self.cycle_comm_volumes.values())
        _trace.event("dist_gmg.hierarchy", levels=levels,
                     shards=self.A.num_shards,
                     cycle_comm_bytes=self.cycle_comm_bytes)

    def _cycle_comm_volumes(self):
        """Bytes of one V-cycle per collective kind
        (``dist_gmg.py:169``): two smoothing SpMVs, one restriction and
        one prolongation on every level above the coarsest."""
        R = self.A.num_shards
        item = self.A.dtype.itemsize
        vols: dict = {}
        levels = [self.A] + [op[1] for op in self.operators]
        for lvl, (dR, coarse_A, dP) in enumerate(self.operators):
            A_l = levels[lvl]
            fine_local = A_l.rows_padded // R
            coarse_local = coarse_A.rows_padded // R
            vols = _comm.merge(
                vols,
                _comm.scale(spmv_comm_volumes(A_l, fine_local, item), 2),
                spmv_comm_volumes(dR, fine_local, item),
                spmv_comm_volumes(dP, coarse_local, item))
        return vols

    def _append_params(self, A: DistCSR, omega: float, power_iters: int):
        diag = dist_diagonal(A).to_local()
        # Padding rows have a zero diagonal: a zero d_inv there.
        d_inv = torch.where(diag != 0,
                            1.0 / torch.where(diag == 0, 1.0, diag), 0.0)
        rho = _dist_max_eigenvalue(A, d_inv, power_iters)
        self.level_params.append((omega / rho, d_inv))

    def cycle(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(self.A, r, 0)

    def _cycle(self, A: DistCSR, r, level: int):
        omega, d_inv = self.level_params[level]
        if level == self.levels - 1:
            return omega * r * d_inv
        dR, coarse_A, dP = self.operators[level]
        x = omega * r * d_inv                      # pre-smooth
        fine_r = r - dist_spmv(A, x)
        coarse_r = dist_spmv(dR, fine_r)
        coarse_x = self._cycle(coarse_A, coarse_r, level + 1)
        x = x + dist_spmv(dP, coarse_x)            # correct
        return x + omega * (r - dist_spmv(A, x)) * d_inv   # post-smooth

    def diagnostics(self) -> str:
        """Hierarchy report (``dist_gmg.py:217``): unknowns and stored
        entries per level (a collective: the counts are all-reduced)."""
        out = ["DistMultilevelSolver", f"Number of Levels: {self.levels}"]
        out.append("  level   unknowns     nonzeros")
        levels = [self.A] + [op[1] for op in self.operators]
        for n, A in enumerate(levels):
            nnz = A.counts.to(torch.int64).sum()
            dist.all_reduce(nnz, group=A.vector_group)
            out.append(f"{n:>6} {A.shape[1]:>11} {int(nnz):>12}")
        return "\n".join(out)
