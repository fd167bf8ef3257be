# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""2-D Poisson problem with Dirichlet boundaries, solved by CG on the port.

The port of ``examples/pde.py:19-108``: the penta-diagonal operator
from ``diags(...).tocsr()`` and a CG solve of the manufactured
right-hand side.  Run it as::

    python -m legate_sparse_tpu_torch.apps.pde -n 512 -m 512 \
        --dtype float32 --tol 1e-5 [--device cpu]

It prints one JSON line: grid, unknowns, iterations, the true relative
residual ``||b - A x|| / ||b||`` and the relative error to the exact
solution (both in float64), whether the residual meets ``tol``, the
SpMV path and the solve's wall time.

The example's other modes (``examples/pde.py``), each a JSON line of its
own with ``mode`` set:

- ``--throughput -i N [-w W]``: CG on ``b = 1`` for ``W`` warm-up
  iterations, then a timed solve of ``N - W`` iterations (it stops
  earlier if it converges to ``tol``); ``ms_per_iter`` is the timed
  solve's time over ``N - W``, as the example divides it.
- ``--explicit -i N [-w W]``: the explicit damped-Jacobi update ``p' = p
  + tau (A p - b)`` (one SpMV and an axpy a step, ``tau = 0.4 / (a +
  g)`` inside the stability region), ``W`` warm-up steps (default
  ``N // 10``) and ``N - W`` timed ones.
- ``--distributed [--ranks R]``: the operator built shard by shard
  (``parallel.dist_diags`` with ``materialize_ell=False``: one DIA copy
  a rank) and solved by ``parallel.dist_cg`` over ``R`` ranks started by
  ``parallel.launch.run_ranks`` (NCCL on ``cuda``, one a card; gloo on
  the CPU), with ``--throughput`` as above.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import diags, linalg
from ..runtime import resolve_device
from ..types import to_torch_dtype
from .common import TorchTimer


def d2_mat_dirichlet_2d(nx: int, ny: int, dx: float, dy: float,
                        dtype=torch.float64, device=None):
    """Centered second-order 2-D Laplacian with Dirichlet boundaries on
    the (nx-2)(ny-2) interior unknowns, as a ``csr_array``."""
    a = 1.0 / dx**2
    g = 1.0 / dy**2
    c = -2.0 * a - 2.0 * g
    # x-coupling, zeroed where consecutive unknowns cross a grid row.
    diag_size = (nx - 2) * (ny - 2) - 1
    diag_a = np.full(diag_size, a)
    diag_a[nx - 3::nx - 2] = 0.0
    diag_g = g * np.ones((nx - 2) * (ny - 3))
    diag_c = c * np.ones((nx - 2) * (ny - 2))
    return diags([diag_g, diag_a, diag_c, diag_a, diag_g],
                 [-(nx - 2), -1, 0, 1, nx - 2], dtype=dtype,
                 device=device).tocsr()


def grid_spacing(nx: int, ny: int):
    """(dx, dy) of the unit-square grid x in [0, 1], y in [-0.5, 0.5]."""
    return 1.0 / (nx - 1), 1.0 / (ny - 1)


def _grid(nx: int, ny: int):
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, nx), np.linspace(-0.5, 0.5, ny),
                       indexing="ij")
    return X, Y


def manufactured_rhs(nx: int, ny: int) -> np.ndarray:
    """The interior right-hand side of ``examples/pde.py``, flattened in
    the operator's (column-major) order, float64."""
    X, Y = _grid(nx, ny)
    b = (np.sin(np.pi * X) * np.cos(np.pi * Y)
         + np.sin(5.0 * np.pi * X) * np.cos(5.0 * np.pi * Y))
    return b[1:-1, 1:-1].flatten("F")


def p_exact_2d(nx: int, ny: int) -> np.ndarray:
    """The exact solution of the manufactured problem
    (``examples/pde.py::p_exact_2d``) at the interior unknowns, in the
    operator's order, float64."""
    X, Y = _grid(nx, ny)
    p = (-1.0 / (2.0 * np.pi**2) * np.sin(np.pi * X) * np.cos(np.pi * Y)
         - 1.0 / (50.0 * np.pi**2) * np.sin(5.0 * np.pi * X)
         * np.cos(5.0 * np.pi * Y))
    return p[1:-1, 1:-1].flatten("F")


def relative_error_to_exact(nx: int, ny: int, x: torch.Tensor) -> float:
    """``||x - p_exact|| / ||p_exact||`` in float64: the discretisation
    error plus the solver's."""
    exact = p_exact_2d(nx, ny)
    xs = x.detach().double().cpu().numpy()
    return float(np.linalg.norm(xs - exact) / np.linalg.norm(exact))


def solve(nx: int, ny: int, tol: float = 1e-10, dtype=torch.float64,
          device=None, maxiter=None) -> dict:
    """Build the operator on ``device``, solve by CG in ``dtype`` to
    relative tolerance ``tol``, and measure the result in float64: the
    true relative residual and the relative error to the exact
    solution.

    In float32 the true residual cannot fall much below
    ``residual_floor = 2^-24 * || |A| |x| || / ||b||``, what the rounding
    of x alone leaves: about 5e-3 on a 512x512 grid, where the rows of
    ``|A|`` sum to 8 / dx^2.  CG stops on its recursive residual, which
    keeps falling; the error to the exact solution shows that the
    iterate is right."""
    dev = resolve_device(device)
    dtype = to_torch_dtype(dtype)
    dx, dy = grid_spacing(nx, ny)
    A = d2_mat_dirichlet_2d(nx, ny, dx, dy, dtype=dtype, device=dev)
    b64 = torch.from_numpy(manufactured_rhs(nx, ny)).to(dev)
    b = b64.to(dtype)
    _ = A @ torch.ones(A.shape[1], dtype=dtype, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    x, iters = linalg.cg(A, b, rtol=tol, maxiter=maxiter)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    path = A.spmv_path
    A64, x64 = A.astype(torch.float64), x.double()
    bnorm = torch.linalg.vector_norm(b64)
    rel = float(torch.linalg.vector_norm(b64 - A64 @ x64) / bnorm)
    # What rounding x to ``dtype`` alone leaves: u * || |A| |x| || / ||b||.
    unit = torch.finfo(dtype).eps / 2
    floor = float(unit * torch.linalg.vector_norm(
        A64._with_data(A64.data.abs()) @ x64.abs()) / bnorm)
    return {"grid": f"{nx}x{ny}", "n": int(A.shape[0]), "iters": int(iters),
            "rel_residual": rel, "residual_floor": floor,
            "converged": rel <= tol,
            "rel_error_to_exact": relative_error_to_exact(nx, ny, x),
            "path": path, "solve_s": seconds, "x": x}


def throughput(nx: int, ny: int, tol: float, max_iters: int,
               warmup_iters: int, dtype=torch.float64, device=None) -> dict:
    """``--throughput``: CG on ``b = 1``, ``warmup_iters`` iterations,
    then a timed solve capped at ``max_iters - warmup_iters``."""
    if not max_iters > warmup_iters:
        raise ValueError("--throughput needs --max-iters > --warmup-iters")
    dev = resolve_device(device)
    dtype = to_torch_dtype(dtype)
    dx, dy = grid_spacing(nx, ny)
    A = d2_mat_dirichlet_2d(nx, ny, dx, dy, dtype=dtype, device=dev)
    b = torch.ones(A.shape[0], dtype=dtype, device=dev)
    _ = A @ torch.ones(A.shape[1], dtype=dtype, device=dev)
    linalg.cg(A, b, rtol=tol, maxiter=warmup_iters)
    timed = max_iters - warmup_iters
    timer = TorchTimer(dev)
    timer.start()
    x, iters = linalg.cg(A, b, rtol=tol, maxiter=timed)
    total_ms = timer.stop()
    return {"mode": "throughput", "grid": f"{nx}x{ny}", "n": int(A.shape[0]),
            "warmup_iters": warmup_iters, "max_iters": timed,
            "iters": int(iters), "ms_per_iter": total_ms / timed,
            "path": A.spmv_path, "x": x}


def explicit(nx: int, ny: int, max_iters: int, warmup_iters=None,
             dtype=torch.float64, device=None) -> dict:
    """``--explicit``: ``max_iters`` steps of ``p' = p + tau (A p - b)``
    from ``p = 0``, ``b = 1``; the steps after the warm-up are timed."""
    dev = resolve_device(device)
    dtype = to_torch_dtype(dtype)
    dx, dy = grid_spacing(nx, ny)
    a, g = 1.0 / dx**2, 1.0 / dy**2
    tau = 0.4 / (a + g)
    A = d2_mat_dirichlet_2d(nx, ny, dx, dy, dtype=dtype, device=dev)
    n = A.shape[0]
    b = torch.ones(n, dtype=dtype, device=dev)
    p = torch.zeros(n, dtype=dtype, device=dev)
    warmup = warmup_iters if warmup_iters else max(1, max_iters // 10)
    if not max_iters > warmup:
        raise ValueError("--explicit needs --max-iters > the warm-up steps")

    def step(v):
        return v + tau * (A.dot(v) - b)

    for _ in range(warmup):
        p = step(p)
    timer = TorchTimer(dev)
    timer.start()
    for _ in range(max_iters - warmup):
        p = step(p)
    total_ms = timer.stop()
    return {"mode": "explicit", "grid": f"{nx}x{ny}", "n": int(n),
            "steps": max_iters, "warmup_iters": warmup,
            "ms_per_iter": total_ms / (max_iters - warmup),
            "path": A.spmv_path, "x": p}


def _distributed_rank(rank, world, nx, ny, throughput_mode, tol, max_iters,
                      warmup_iters, dtype, return_x):
    """One rank of ``distributed``: rank 0's record."""
    from .. import parallel as P, runtime
    from ..parallel import dist_csr as D
    from ..parallel.mesh import device_type

    if device_type() == "cpu":
        runtime.set_device("cpu")
    dev = runtime.default_device()
    dtype = to_torch_dtype(dtype)
    dx, dy = grid_spacing(nx, ny)
    a, g = 1.0 / dx**2, 1.0 / dy**2
    c = -2.0 * a - 2.0 * g
    m = nx - 2
    n = m * (ny - 2)

    def off1(i):
        # x-coupling zeroed across grid rows, as in d2_mat_dirichlet_2d.
        return torch.where((i + 1) % m == 0, 0.0, a)

    timer = TorchTimer(dev)
    timer.start()
    mesh = P.make_row_mesh()
    dA = P.dist_diags([c, off1, off1, g, g], [0, 1, -1, m, -m],
                      shape=(n, n), mesh=mesh, dtype=dtype,
                      materialize_ell=False)
    build_ms = timer.stop()
    # b in the operator's dtype: a wider b would promote the products to
    # the plain shifted adds.
    if throughput_mode:
        if not max_iters > warmup_iters:
            raise ValueError("--throughput needs --max-iters > "
                             "--warmup-iters")
        b = torch.ones(n, dtype=dtype, device=dev)
        P.dist_cg(dA, b, rtol=tol, maxiter=warmup_iters)
        maxiter = max_iters - warmup_iters
    else:
        b = torch.from_numpy(manufactured_rhs(nx, ny)).to(dev, dtype)
        maxiter = None
    timer.start()
    x, iters = P.dist_cg(dA, b, rtol=tol, maxiter=maxiter)
    total_ms = timer.stop()
    xg = x.full_tensor()
    r = P.dist_spmv(dA, D.shard_vector(xg, mesh, dA.rows_padded))
    b64 = b.double()
    res = float(torch.linalg.vector_norm(
        b64 - r.full_tensor()[:n].double()) / torch.linalg.vector_norm(b64))
    out = {"mode": "distributed", "throughput": bool(throughput_mode),
           "grid": f"{nx}x{ny}", "n": n, "ranks": world,
           "iters": int(iters), "rel_residual": res,
           "converged": res <= tol, "build_ms": build_ms,
           "solve_ms": total_ms,
           "ms_per_iter": total_ms / (maxiter if throughput_mode
                                      else max(int(iters), 1)),
           "spmv_path": dA.spmv_path}
    if return_x and rank == 0:
        out["x"] = xg.cpu().numpy()
    return out


def distributed(nx: int, ny: int, throughput_mode: bool = False,
                tol: float = 1e-10, max_iters=None, warmup_iters=None,
                dtype=torch.float64, device=None, ranks: int = 1,
                return_x: bool = False) -> dict:
    """``--distributed``: ``dist_diags`` + ``dist_cg`` over ``ranks``
    ranks (NCCL on ``cuda``, gloo on the CPU); rank 0's record (with
    ``return_x``, the solution as a numpy array)."""
    from ..parallel.launch import run_ranks

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    return run_ranks(_distributed_rank, ranks, backend=backend, timeout=900,
                     args=(nx, ny, throughput_mode, tol, max_iters,
                           warmup_iters or 0, to_torch_dtype(dtype),
                           return_x))[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-n", "--nx", type=int, default=128)
    ap.add_argument("-m", "--ny", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("-i", "--max-iters", type=int, default=None,
                    dest="max_iters")
    ap.add_argument("-t", "--throughput", action="store_true")
    ap.add_argument("-w", "--warmup-iters", type=int, default=None,
                    dest="warmup_iters")
    ap.add_argument("--explicit", action="store_true",
                    help="time the explicit damped-Jacobi update (one SpMV "
                    "and an axpy a step) instead of the CG solve")
    ap.add_argument("--distributed", action="store_true",
                    help="shard-local build and dist_cg over the ranks")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of --distributed (default: the visible "
                    "cards on cuda, 1 on the CPU)")
    args = ap.parse_args(argv)
    if (args.throughput or args.explicit) and args.max_iters is None:
        ap.error("--throughput and --explicit need --max-iters")
    dev = resolve_device(args.device)
    if args.explicit:
        out = explicit(args.nx, args.ny, args.max_iters, args.warmup_iters,
                       dtype=args.dtype, device=dev)
    elif args.distributed:
        ranks = args.ranks or (torch.cuda.device_count()
                               if dev.type == "cuda" else 1)
        out = distributed(args.nx, args.ny, args.throughput, args.tol,
                          args.max_iters, args.warmup_iters,
                          dtype=args.dtype, device=dev, ranks=ranks)
    elif args.throughput:
        out = throughput(args.nx, args.ny, args.tol, args.max_iters,
                         args.warmup_iters or 0, dtype=args.dtype,
                         device=dev)
    else:
        out = solve(args.nx, args.ny, tol=args.tol, dtype=args.dtype,
                    device=dev, maxiter=args.max_iters)
    out.pop("x", None)
    out["device"] = str(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
