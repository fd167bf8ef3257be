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
    args = ap.parse_args(argv)
    out = solve(args.nx, args.ny, tol=args.tol, dtype=args.dtype,
                device=args.device, maxiter=args.max_iters)
    out.pop("x")
    out["device"] = str(resolve_device(args.device))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
