# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Geometric-multigrid-preconditioned CG for the 2-D Poisson problem.

The port of ``examples/gmg.py``: a V-cycle with weighted-Jacobi
smoothing, injection or full-weighting (``linear``) restriction built
as CSR on the host, prolongation ``P = R.T``, and Galerkin coarse
operators ``A_c = R @ A @ P`` (two SpGEMMs per level, through ESC),
used as the preconditioner ``M`` of ``linalg.cg``.  The operator is
``apps.common.poisson2D`` or, with ``--data diffusion``,
``apps.common.diffusion2D``.  Random vectors come from numpy
generators seeded as the example seeds them (``default_rng(7)`` for the
spectral-radius estimate, ``default_rng(0)`` for the right-hand side)
and are cast to the operator's dtype.  Run it as::

    python -m legate_sparse_tpu_torch.apps.gmg -n 512 -l 6 -g linear \
        --dtype float32 --tol 1e-5 [--compare-plain] [--device cpu]

It prints the hierarchy and one JSON line: iterations, the true
relative residual ``||b - A x|| / ||b||`` in float64 beside what the
rounding of x to ``dtype`` alone leaves (``residual_floor``, as
``apps/pde.py``), the hierarchy's build seconds (split into
restriction operators, Galerkin products and smoother set-up), the
first V-cycle's seconds (structure packs), the solve's seconds and ms
per iteration, the route of every SpGEMM and the SpMV path of every
operator; with ``--compare-plain``, the same solve by plain CG; with
``--profile``, the device time by kernel of the GMG-CG solve and of 200
plain CG iterations, from ``torch.profiler``.  ``--verbose`` prints the
true residual at every iteration (a host sync each); ``--warmup`` runs
a small SpGEMM (``A.T @ A`` of a 64x64 diffusion operator) first.

``--distributed [--ranks R]`` is the example's multi-rank rendition:
the operator sharded by ``parallel.shard_csr``, the hierarchy
``parallel.DistGMG(levels, gridop, power_iters)`` and
``parallel.dist_cg(M=gmg.cycle)`` over ``R`` ranks started by
``parallel.launch.run_ranks`` (NCCL on ``cuda``, one a card; gloo on
the CPU).  Its JSON line has ``mode: "distributed"``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from .. import linalg
from ..csr import csr_array, csr_matrix
from ..obs import timeline as _timeline
from ..obs import trace as _trace
from ..runtime import resolve_device
from ..types import to_torch_dtype
from .common import diffusion2D, poisson2D


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _synced_ns(device: torch.device) -> int:
    """``obs``'s clock, read once the device is synchronised."""
    _sync(device)
    return _trace.clock_ns()


def max_eigenvalue(A, iters: int = 15) -> float:
    """Spectral-radius estimate by power iteration and a Rayleigh
    quotient, from ``default_rng(7)``."""
    rng = np.random.default_rng(7)
    x1 = torch.from_numpy(rng.random(A.shape[1]).reshape(-1, 1)).to(
        A.device, A.dtype)
    for _ in range(iters):
        x1 = A @ x1
        x1 = x1 / torch.linalg.vector_norm(x1)
    return float((x1.T @ (A @ x1)).item())


class WeightedJacobi:
    """Weighted-Jacobi smoother, omega scaled per level by the spectral
    radius of D^-1 A (``power_iters`` power iterations)."""

    def __init__(self, omega: float = 4.0 / 3.0, power_iters: int = 1):
        self.level_params = []
        self._init_omega = omega
        self._power_iters = power_iters
        # Route of each level's A @ D^-1 product.
        self.spgemm_paths = []

    def init_level_params(self, A, level: int) -> None:
        D_inv = 1.0 / A.diagonal()
        n = min(A.shape)
        idx = torch.arange(n, dtype=torch.int64, device=A.device)
        D_inv_mat = csr_array((D_inv, (idx, idx)), shape=A.shape)
        AD = A @ D_inv_mat
        self.spgemm_paths.append(A.spgemm_path)
        omega = self._init_omega / max_eigenvalue(AD, self._power_iters)
        self.level_params.append((omega, D_inv))
        assert len(self.level_params) - 1 == level

    def pre(self, A, r, x, level: int):
        assert x is None
        omega, D_inv = self.level_params[level]
        return omega * r * D_inv

    def post(self, A, r, x, level: int):
        omega, D_inv = self.level_params[level]
        return x + omega * (r - A @ x) * D_inv

    def coarse(self, A, r, x, level: int):
        return self.pre(A, r, x, level)


def injection_operator(fine_dim: int, dtype=torch.float64, device=None):
    """Injection restriction: coarse (i, j) samples fine (2i, 2j)."""
    fine_shape = (int(np.sqrt(fine_dim)),) * 2
    coarse_shape = (fine_shape[0] // 2, fine_shape[1] // 2)
    coarse_dim = int(np.prod(coarse_shape))
    ij = np.arange(coarse_dim, dtype=np.int64)
    i = ij // coarse_shape[1]
    j = ij % coarse_shape[1]
    Rj = 2 * i * fine_shape[1] + 2 * j
    Rp = np.arange(coarse_dim + 1, dtype=np.int64)
    Rx = np.ones(coarse_dim, dtype=np.float64)
    R = csr_matrix((Rx, Rj, Rp), shape=(coarse_dim, fine_dim),
                   dtype=dtype, device=resolve_device(device))
    return R, coarse_dim


def linear_operator(fine_dim: int, dtype=torch.float64, device=None):
    """Full-weighting (bilinear) restriction: the 9-point stencil with
    weights 1/16, 2/16, 4/16, built with vectorised numpy."""
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
    R = csr_matrix((np.concatenate(vals),
                    (np.concatenate(rows), np.concatenate(cols))),
                   shape=(coarse_dim, fine_dim), dtype=dtype,
                   device=resolve_device(device))
    return R, coarse_dim


class GMG:
    """Geometric multigrid V-cycle used as a CG preconditioner.  The
    restriction operators take A's dtype and device."""

    def __init__(self, A, shape, levels: int, smoother: str = "jacobi",
                 gridop: str = "linear", power_iters: int = 1):
        self.A = A
        self.shape = shape
        self.N = int(np.prod(shape))
        self.levels = levels
        self.restriction_op = {"injection": injection_operator,
                               "linear": linear_operator}[gridop]
        self.smoother = {"jacobi": WeightedJacobi}[smoother](
            power_iters=power_iters)
        # Route of each level's R @ A and (R A) @ P.
        self.spgemm_paths = []
        self.operators = self.compute_operators(A)

    def compute_operators(self, A):
        """The (R, A_c, P) of every level; ``self.build_s`` splits the
        seconds between the restriction operators, the Galerkin
        products and the smoother's set-up, each the sum of its laps
        (the device synchronised at every lap's end).  While tracing,
        each lap is a span ``gmg.build.<part>`` with its ``level``."""
        operators = []
        dim = self.N
        self.build_s = {"restriction": 0.0, "galerkin": 0.0, "smoother": 0.0}
        t = _synced_ns(A.device)

        def lap(part: str, level: int) -> None:
            nonlocal t
            now = _synced_ns(A.device)
            self.build_s[part] += (now - t) * 1e-9
            _trace.complete_span("gmg.build." + part, t, now - t,
                                 level=level)
            t = now

        self.smoother.init_level_params(A, 0)
        lap("smoother", 0)
        for level in range(self.levels):
            R, dim = self.restriction_op(dim, dtype=A.dtype, device=A.device)
            P = R.T
            lap("restriction", level)
            RA = R @ A              # Galerkin triple product: two SpGEMMs
            A = RA @ P
            self.spgemm_paths.append({"R@A": R.spgemm_path,
                                      "RA@P": RA.spgemm_path})
            del RA
            lap("galerkin", level + 1)
            self.smoother.init_level_params(A, level + 1)
            lap("smoother", level + 1)
            operators.append((R, A, P))
        return operators

    def cycle(self, r):
        """One V-cycle (a span ``gmg.cycle`` while tracing)."""
        with _trace.span("gmg.cycle"):
            return self._cycle(self.A, r, 0)

    def _cycle(self, A, r, level: int):
        """The V-cycle from ``level`` down (a span ``gmg.level`` while
        tracing, holding the spans of the levels below)."""
        with _trace.span("gmg.level", level=level, rows=A.shape[0]):
            if level == self.levels - 1:
                return self.smoother.coarse(A, r, None, level=level)
            R, coarse_A, P = self.operators[level]
            x = self.smoother.pre(A, r, None, level=level)
            fine_r = r - A.dot(x)
            coarse_r = R.dot(fine_r)
            coarse_x = self._cycle(coarse_A, coarse_r, level + 1)
            x_corrected = x + P @ coarse_x
            return self.smoother.post(A, r, x_corrected, level=level)

    def linear_operator(self):
        return linalg.LinearOperator(self.A.shape, dtype=self.A.dtype,
                                     matvec=self.cycle)

    def spmv_paths(self):
        """The SpMV path each operator of the V-cycle took last."""
        out = [{"A": self.A.spmv_path}]
        for R, A, P in self.operators:
            out[-1].update(R=R.spmv_path, P=P.spmv_path)
            out.append({"A": A.spmv_path})
        return out


def print_diagnostics(operators) -> str:
    """Multigrid hierarchy report."""
    output = "MultilevelSolver\n"
    output += f"Number of Levels:     {len(operators)}\n"
    total_nnz = sum(level[1].nnz for level in operators)
    output += "  level   unknowns     nonzeros\n"
    for n, level in enumerate(operators):
        A = level[1]
        ratio = 100 * A.nnz / total_nnz
        output += f"{n:>6} {A.shape[1]:>11} {A.nnz:>12} [{ratio:2.2f}%]\n"
    return output


def profile_device(fn, device: torch.device, top: int = 12) -> dict:
    """Run ``fn`` once inside ``obs.timeline.Slice``: the device time
    summed over its operations, its share of the slice's wall time and
    the ``top`` operations by device time.  Off a card nothing is
    profiled and the device time reads 0."""
    t0 = _trace.clock_ns()
    with _timeline.Slice(device) as sl:
        fn()
    tl = sl.timeline
    wall_ms = (sl.wall_s * 1e3 if tl is not None
               else (_trace.clock_ns() - t0) * 1e-6)
    by: dict = {}
    for name, start, end, _ in (tl.ops if tl is not None else ()):
        ms, count = by.get(name, (0.0, 0))
        by[name] = (ms + (end - start) * 1e-3, count + 1)
    rows = sorted(((ms, k, c) for k, (ms, c) in by.items()),
                  key=lambda r: -r[0])
    device_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else 0.0,
            "top": [{"kernel": k[:96], "ms": ms, "count": c}
                    for ms, k, c in rows[:top]]}


def _residuals(A, b64, x):
    """(true relative residual, f32-or-f64 rounding floor), both f64."""
    A64, x64 = A.astype(torch.float64), x.double()
    bnorm = torch.linalg.vector_norm(b64)
    rel = float(torch.linalg.vector_norm(b64 - A64 @ x64) / bnorm)
    unit = torch.finfo(x.dtype).eps / 2
    floor = float(unit * torch.linalg.vector_norm(
        A64._with_data(A64.data.abs()) @ x64.abs()) / bnorm)
    return rel, floor


def solve(N: int, levels: int, gridop: str = "linear", tol: float = 1e-10,
          dtype=torch.float64, device=None, maxiter: int = 200,
          power_iters: int = 1, compare_plain: bool = False,
          plain_maxiter=None, profile: bool = False,
          watch=contextlib.nullcontext, data: str = "poisson",
          verbose: bool = False, warmup: bool = False) -> dict:
    """Build the N x N operator (``data``: ``poisson`` or ``diffusion``)
    and its GMG hierarchy on
    ``device``, solve ``A x = b`` (b from ``default_rng(0)``) by
    GMG-preconditioned CG to relative tolerance ``tol``, and measure
    the result in float64.  With ``compare_plain`` also solve by plain
    CG (``plain_maxiter``, default 10 N^2).  With ``profile``, run the
    GMG-CG solve (and 200 plain CG iterations) once more under
    ``torch.profiler`` (``profile_device``).  ``watch()``, a context
    manager, is entered around the GMG-CG solve alone: the hierarchy's
    build, the warm-up V-cycle and the comparisons stay outside it
    (``chip_smoke.py`` counts the kernels' launches in it).
    ``verbose`` prints the true residual of every iterate of the GMG-CG
    solve; ``warmup`` runs one small SpGEMM before anything is
    timed."""
    dev = resolve_device(device)
    dtype = to_torch_dtype(dtype)
    if warmup:
        tA = diffusion2D(64, epsilon=0.1, theta=np.pi / 4, dtype=dtype,
                         device=dev)
        tA.T @ tA
    A = _operator(data, N, dtype, dev)
    b64 = torch.from_numpy(np.random.default_rng(0).random(N * N)).to(dev)
    b = b64.to(dtype)
    t0 = _synced_ns(dev)
    mg = GMG(A, (N, N), levels, "jacobi", gridop, power_iters)
    M = mg.linear_operator()
    t1 = _synced_ns(dev)
    # Warm the structure caches (DIA, ELL and BSR packs) and kernels
    # outside the timed solve.
    zero = torch.zeros(N * N, dtype=dtype, device=dev)
    A.dot(zero)
    M.matvec(zero)
    t2 = _synced_ns(dev)
    with watch():
        x, iters = linalg.cg(
            A, b, rtol=tol, maxiter=maxiter, M=M,
            callback=_residual_printer(A, b) if verbose else None)
    t3 = _synced_ns(dev)
    build_s, first_cycle_s, solve_s = (
        (t1 - t0) * 1e-9, (t2 - t1) * 1e-9, (t3 - t2) * 1e-9)
    rel, floor = _residuals(A, b64, x)
    out = {"grid": f"{N}x{N}", "n": N * N, "data": data, "levels": levels,
           "gridop": gridop, "dtype": str(dtype).split(".")[-1],
           "iters": int(iters), "rel_residual": rel,
           "residual_floor": floor, "converged": rel <= tol,
           "build_s": build_s, "build_breakdown_s": mg.build_s,
           "first_cycle_s": first_cycle_s, "solve_s": solve_s,
           "ms_per_iter": solve_s * 1e3 / max(int(iters), 1),
           "hierarchy": [[int(lv[1].shape[0]), int(lv[1].nnz)]
                         for lv in mg.operators],
           "spgemm_paths": mg.spgemm_paths,
           "smoother_spgemm_paths": mg.smoother.spgemm_paths,
           "spmv_paths": mg.spmv_paths(), "x": x, "gmg": mg}
    if compare_plain:
        t0 = _synced_ns(dev)
        xp, iters_p = linalg.cg(A, b, rtol=tol, maxiter=plain_maxiter)
        plain_s = (_synced_ns(dev) - t0) * 1e-9
        rel_p, _ = _residuals(A, b64, xp)
        out.update(plain_iters=int(iters_p), plain_s=plain_s,
                   plain_ms_per_iter=plain_s * 1e3 / max(int(iters_p), 1),
                   plain_rel_residual=rel_p)
    if profile:
        out["profile_gmg_cg"] = profile_device(
            lambda: linalg.cg(A, b, rtol=tol, maxiter=maxiter, M=M), dev)
        out["profile_plain_cg_200"] = profile_device(
            lambda: linalg.cg(A, b, rtol=0.0, maxiter=200), dev)
    return out


def _operator(data: str, N: int, dtype, device) -> csr_array:
    """The N*N system matrix of ``--data``."""
    gen = {"poisson": poisson2D, "diffusion": diffusion2D}.get(data)
    if gen is None:
        raise ValueError(f"unknown --data {data!r}")
    return gen(N, dtype=dtype, device=device)


def _residual_printer(A, b, show: bool = True):
    """The ``--verbose`` callback: the true residual of each iterate
    (a sharded iterate is gathered first, a collective every rank runs;
    ``show`` on one rank alone)."""
    def callback(x):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        r = float(torch.linalg.vector_norm(b - A @ x.to(A.dtype)))
        if show:
            print(f"Residual: {r}", flush=True)
    return callback


def _distributed_rank(rank, world, N, data, levels, gridop, tol, maxiter,
                      power_iters, dtype, verbose, return_x):
    """One rank of ``distributed``: rank 0's record."""
    from .. import parallel as P, runtime
    from ..parallel.mesh import device_type

    if device_type() == "cpu":
        runtime.set_device("cpu")
    dev = runtime.default_device()
    A = _operator(data, N, dtype, dev)
    b64 = torch.from_numpy(np.random.default_rng(0).random(N * N)).to(dev)
    b = b64.to(dtype)
    t0 = _synced_ns(dev)
    dA = P.shard_csr(A, mesh=P.make_row_mesh())
    mg = P.DistGMG(dA, levels=levels, gridop=gridop, power_iters=power_iters)
    build_s = (_synced_ns(dev) - t0) * 1e-9
    diagnostics = mg.diagnostics()
    callback = _residual_printer(A, b, rank == 0) if verbose else None
    t0 = _synced_ns(dev)
    x, iters = P.dist_cg(dA, b, M=mg.cycle, rtol=tol, maxiter=maxiter,
                         callback=callback)
    solve_s = (_synced_ns(dev) - t0) * 1e-9
    x = x.full_tensor()
    rel, floor = _residuals(A, b64, x)
    out = {"mode": "distributed", "grid": f"{N}x{N}", "n": N * N,
           "data": data, "levels": levels, "gridop": gridop,
           "dtype": str(dtype).split(".")[-1], "ranks": world,
           "iters": int(iters), "rel_residual": rel,
           "residual_floor": floor, "converged": rel <= tol,
           "build_s": build_s, "solve_s": solve_s,
           "ms_per_iter": solve_s * 1e3 / max(int(iters), 1),
           "diagnostics": diagnostics}
    if return_x and rank == 0:
        out["x"] = x.cpu().numpy()
    return out


def distributed(N: int, levels: int, data: str = "poisson",
                gridop: str = "injection", tol: float = 1e-10,
                dtype=torch.float64, device=None, maxiter: int = 200,
                power_iters: int = 1, ranks: int = 1, verbose: bool = False,
                return_x: bool = False) -> dict:
    """GMG-CG over ``ranks`` ranks (NCCL on ``cuda``, gloo on the CPU):
    ``shard_csr`` -> ``DistGMG`` -> ``dist_cg(M=gmg.cycle)``; rank 0's
    record (with ``return_x``, the solution as a numpy array)."""
    from ..parallel.launch import run_ranks

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    return run_ranks(_distributed_rank, ranks, backend=backend, timeout=900,
                     args=(N, data, levels, gridop, tol, maxiter,
                           power_iters, to_torch_dtype(dtype), verbose,
                           return_x))[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-n", "--num", type=int, default=16, dest="N")
    ap.add_argument("-l", "--levels", type=int, default=2)
    ap.add_argument("-g", "--gridop", choices=["linear", "injection"],
                    default="injection")
    ap.add_argument("-m", "--maxiter", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--power-iters", type=int, default=1,
                    dest="power_iters")
    ap.add_argument("--compare-plain", action="store_true",
                    help="also solve by plain CG and report its iterations")
    ap.add_argument("--profile", action="store_true",
                    help="also run the solves under torch.profiler and "
                    "report device time by kernel")
    ap.add_argument("-d", "--data", choices=["poisson", "diffusion"],
                    default="poisson")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print the true residual at every iteration")
    ap.add_argument("-w", "--warmup", action="store_true",
                    help="run a small SpGEMM before timing")
    ap.add_argument("--distributed", action="store_true",
                    help="DistGMG and dist_cg over the ranks")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of --distributed (default: the visible "
                    "cards on cuda, 1 on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.distributed:
        ranks = args.ranks or (torch.cuda.device_count()
                               if dev.type == "cuda" else 1)
        out = distributed(args.N, args.levels, data=args.data,
                          gridop=args.gridop, tol=args.tol, dtype=args.dtype,
                          device=dev, maxiter=args.maxiter,
                          power_iters=args.power_iters, ranks=ranks,
                          verbose=args.verbose)
        print(out.pop("diagnostics"), file=sys.stderr)
    else:
        out = solve(args.N, args.levels, gridop=args.gridop, tol=args.tol,
                    dtype=args.dtype, device=dev, maxiter=args.maxiter,
                    power_iters=args.power_iters,
                    compare_plain=args.compare_plain, profile=args.profile,
                    data=args.data, verbose=args.verbose,
                    warmup=args.warmup)
        print(print_diagnostics(out.pop("gmg").operators), file=sys.stderr)
        out.pop("x")
    out["device"] = str(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
