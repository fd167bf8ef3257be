"""The system under test: with ``spbench/preconditioners/``, the only
code of the benchmark that calls the program (``legate_sparse_tpu_torch``).

It hands the program the benchmark's inputs through the program's
public entry points (``csr_array``, ``A @ x``, the solvers of
``linalg``, and the preconditioners that ``preconditioners/<name>.py``
builds) and takes back their results.  The program is imported when a
function here first runs, after ``run.py`` has pointed the program's
build directory into the checkout.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _lst():
    import legate_sparse_tpu_torch

    return legate_sparse_tpu_torch


def load_kernels(device: torch.device) -> None:
    """One product of a small band: the program loads its DIA kernel
    (and builds it, the first time in a checkout) before anything is
    timed."""
    n = 64
    idx = torch.arange(n, dtype=torch.int64, device=device)
    A = _lst().csr_array((torch.ones(n, device=device), idx,
                          torch.arange(n + 1, dtype=torch.int64,
                                       device=device)), shape=(n, n))
    A @ torch.ones(n, device=device)


def operator(data, indices, indptr, shape):
    return _lst().csr_array((data, indices, indptr), shape=tuple(shape))


def matvec(A, x: torch.Tensor) -> torch.Tensor:
    return A @ x


def wrap(M, before: Callable, after: Callable):
    """``M`` as a linear operator that calls ``before(r)`` and
    ``after(r, z)`` around each application ``z = M r``."""
    from legate_sparse_tpu_torch import linalg

    def matvec(r):
        before(r)
        z = M.matvec(r)
        after(r, z)
        return z

    return linalg.LinearOperator(M.shape, matvec=matvec, dtype=M.dtype)


def solve(A, b: torch.Tensor, solver: dict, M: Optional[object] = None):
    """``linalg.<solver["name"]>(A, b, M=M, **the rest of solver)`` from
    x0 = 0: ``(x, iterations)``."""
    from legate_sparse_tpu_torch import linalg

    args = {k: v for k, v in solver.items() if k != "name"}
    x, iters = getattr(linalg, solver["name"])(A, b, M=M, **args)
    return x, int(iters)
