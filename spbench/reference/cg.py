"""The plain reference of the ``cg`` solver: preconditioned conjugate
gradients from x0 = 0 in float64, for the iteration at which a solve
of the configured ``rtol`` may stop.

Plain PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def crossing(apply: Callable, precond: Optional[Callable], b: torch.Tensor,
             rtol: float, maxiter: int) -> int:
    """The first iteration after which the residual (the recurrence's,
    as CG keeps it) is under ``rtol * |b|``, testing every iteration;
    ``maxiter`` where none is.  ``apply`` and ``precond`` take and give
    float64 vectors."""
    b = b.to(torch.float64)
    atol = rtol * float(torch.linalg.vector_norm(b))
    r = b.clone()
    z = precond(r) if precond is not None else r
    p = z.clone()
    rho = torch.dot(r, z)
    for k in range(1, maxiter + 1):
        q = apply(p)
        r -= (rho / torch.dot(p, q)) * q
        if float(torch.linalg.vector_norm(r)) < atol:
            return k
        z = precond(r) if precond is not None else r
        rho_new = torch.dot(r, z)
        p = z + (rho_new / rho) * p
        rho = rho_new
    return maxiter
