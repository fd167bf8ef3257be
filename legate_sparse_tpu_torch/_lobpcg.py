# Copyright 2022 The JAX Authors.
# Copyright 2026.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     https://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
"""LOBPCG for the top k eigenpairs of a standard Hermitian problem.

A PyTorch translation of ``jax.experimental.sparse.linalg``'s
``lobpcg_standard`` (jax 0.9.0: ``_lobpcg_standard_callable``,
``_check_inputs``, ``_svqb``, ``_project_out``, ``_orthonormalize``,
``_rayleigh_ritz_orth``, ``_extend_basis``), which the JAX package's
``eigen.lobpcg`` calls.  The algorithm and its arithmetic are jax's;
what differs is the shell:

- jax's ``while_loop`` is a Python loop over device tensors; the
  stopping test needs the count of converged pairs on the host, one
  fetch an iteration, made through ``linalg._host_fetch``.
- ``A`` takes whole blocks: ``A(X)`` on (n, k) and ``A(XPR)`` on
  (n, 3k), so a sparse operator applies one SpMM a block.
- jax's products run at ``Precision.HIGHEST``; here float32 products
  run in full float32 (``torch.set_float32_matmul_precision("highest")``
  for the solve, so no TF32).
- ``_extend_basis`` multiplies by the first ``m`` rows of ``w[k:]``
  directly instead of by an (n - k, m) identity-and-zeros block (the
  same sums).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import torch

__all__ = ["lobpcg_standard"]


@contextlib.contextmanager
def _full_f32_products():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def lobpcg_standard(A: Union[torch.Tensor, Callable], X: torch.Tensor,
                    m: int = 100, tol: Optional[float] = None):
    """The top ``k`` eigenpairs of a Hermitian ``A`` (a dense (n, n)
    tensor or a callable taking an (n, j) block to an (n, j) block) from
    the start block ``X`` (n, k), ``0 < 5k < n``.  A pair is converged
    when ``|A v - θ v| < tol · 10 · n · (θ + |A v|)`` (``tol`` defaults
    to the dtype's eps); the loop stops when all ``k`` are, or after
    ``m`` iterations.  Returns ``(theta, U, i)``: the (k,) eigenvalues
    in descending order, the (n, k) eigenvectors and the iteration
    count."""
    if isinstance(A, torch.Tensor):
        mat = A
        A = lambda S: mat @ S  # noqa: E731
    with _full_f32_products():
        return _lobpcg_standard_callable(A, X, int(m), tol)


def _lobpcg_standard_callable(A: Callable, X: torch.Tensor, m: int, tol):
    from .linalg import _host_fetch

    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])

    # X, the current best eigenvectors; P, the search directions; R, the
    # residuals: column-stacked as XPR, (n, 3k).
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    i = 0
    converged = 0
    while i < m and converged < k:
        # Invariants: X, P, R orthonormal; some R, P columns may be 0
        # (basis truncation), never X's.
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)

        theta, Q = _rayleigh_ritz_orth(A, XPR)

        B = Q[:, :k]
        B = B / torch.linalg.vector_norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)

        # span(X, P) == span(X, previous X): orthogonalise
        # concat(0, Q[k:, :k]) against Q[:, :k] in the standard basis
        # before mapping with XPR (jax's note; [2] section 4.2).
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.vector_norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, 1.0, normP)

        AX = A(X)
        R = AX - theta[None, :k] * X
        resid_norms = torch.linalg.vector_norm(R, dim=0)
        # Self-consistency of each pair: the residual against the
        # rounding expected from computing it.
        reltol = (torch.linalg.vector_norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int(_host_fetch(
            torch.sum(resid_norms < tol * reltol))[0])
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _check_inputs(A: Callable, X: torch.Tensor) -> None:
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if test_output.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were "
                         f"{test_output.dtype}, {X.dtype})")
    if tuple(test_output.shape) != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output "
                         f"{tuple(test_output.shape)}")


def _eigh_descending(S: torch.Tensor):
    w, V = torch.linalg.eigh(S)
    return w.flip(0), V.flip(1)


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """A truncated orthonormal basis of ``X`` (SVQB, Stathopoulos & Wu):
    eigendecompose ``X^T X`` and zero the columns of directions whose
    eigenvalue is below ``eps`` times the largest."""
    norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    # tau == 0: X was all zeros.
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = torch.linalg.vector_norm(orthoX, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The component of ``U`` orthogonal to the orthonormal ``basis``
    (zero columns allowed), its nonzero columns orthonormal: subtract and
    orthonormalise twice ("twice is enough", Kahan/Parlett), subtract
    twice more, and zero every column that lost more than 1% of its
    norm there, so that ``[basis, U]`` stays zero-or-orthogonal."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.vector_norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A: Callable, S: torch.Tensor):
    """Eigenpairs ``(w, V)`` of ``S^T A S`` for an orthonormal ``S``
    (zero columns allowed), descending."""
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` directions orthonormal to each other and to the orthonormal
    (n, k) ``X``, from a block Householder reflector (Schreiber & Van
    Loan): deterministic, and never overlapping X."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    h = -2 * (w @ w[k:k + m].T)
    h[k:k + m] += torch.eye(m, dtype=X.dtype, device=X.device)
    return h
