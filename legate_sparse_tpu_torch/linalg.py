# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Linear operators and the conjugate-gradient solver.

Mirrors ``legate_sparse_tpu/linalg.py``: ``LinearOperator`` (``:48``),
``_SparseMatrixLinearOperator`` (``:153``), ``IdentityOperator``
(``:229``), ``make_linear_operator`` (``:270``), ``_get_atol_rtol``
(``:319``) and ``cg`` (``:588``).

The JAX package runs the whole CG solve as one ``lax.while_loop``
(``_cg_builders``, ``:430-469``).  Here the loop is a Python loop over
device tensors with the same iteration: safe divides, ``done`` tested
only when ``iters % conv_test_iters == 0`` or ``iters == maxiter - 1``,
and the same returned iteration count.  The device→host sync (one
``.item()``) happens only at those check iterations.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from .csr import csr_array
from .runtime import resolve_device
from .utils import (as_tensor, fill_out, find_common_type,
                    is_sparse_matrix)
from .types import to_torch_dtype


class LinearOperator:
    """Common interface for matrix-vector products (scipy's shape):
    matrices, callables and compositions behind ``matvec``."""

    ndim = 2

    def __new__(cls, *args, **kwargs):
        if cls is LinearOperator:
            return super().__new__(_CustomLinearOperator)
        obj = super().__new__(cls)
        if (type(obj)._matvec == LinearOperator._matvec
                and type(obj)._matmat == LinearOperator._matmat):
            warnings.warn("LinearOperator subclass should implement at "
                          "least one of _matvec and _matmat.",
                          category=RuntimeWarning, stacklevel=2)
        return obj

    def __init__(self, dtype, shape):
        self.dtype = to_torch_dtype(dtype) if dtype is not None else None
        self.shape = tuple(int(s) for s in shape)

    def _matvec(self, x, out=None):
        return self._matmat(x.reshape(-1, 1), out=out).reshape(-1)

    def _matmat(self, X, out=None):
        return torch.stack([self._matvec(X[:, j]) for j in range(X.shape[1])],
                           dim=1)

    def _rmatvec(self, x, out=None):
        raise NotImplementedError("rmatvec is not defined")

    def matvec(self, x, out=None):
        M, N = self.shape
        if tuple(x.shape) != (N,) and tuple(x.shape) != (N, 1):
            raise ValueError("dimension mismatch")
        return self._matvec(x, out=out)

    def rmatvec(self, x, out=None):
        M, N = self.shape
        if tuple(x.shape) != (M,) and tuple(x.shape) != (M, 1):
            raise ValueError("dimension mismatch")
        return self._rmatvec(x, out=out)

    def matmat(self, X, out=None):
        if X.dim() != 2:
            raise ValueError("expected 2-d array")
        if X.shape[0] != self.shape[1]:
            raise ValueError("dimension mismatch")
        return self._matmat(X, out=out)

    def __matmul__(self, x):
        return self.matvec(x) if x.dim() == 1 else self.matmat(x)


class _CustomLinearOperator(LinearOperator):
    """LinearOperator from user callables (reference ``linalg.py:312-372``).
    Without a ``dtype`` it is taken from one matvec of a float64 zero
    vector on ``device``."""

    def __init__(self, shape, matvec, rmatvec=None, matmat=None,
                 dtype=None, device=None):
        super().__init__(dtype, shape)
        self._matvec_impl = matvec
        self._rmatvec_impl = rmatvec
        self._matmat_impl = matmat
        if self.dtype is None:
            v = torch.zeros(self.shape[-1], dtype=torch.float64,
                            device=resolve_device(device))
            self.dtype = self._matvec_impl(v).dtype

    def _matvec(self, x, out=None):
        return fill_out(self._matvec_impl(x), out)

    def _rmatvec(self, x, out=None):
        if self._rmatvec_impl is None:
            raise NotImplementedError("rmatvec is not defined")
        return fill_out(self._rmatvec_impl(x), out)

    def _matmat(self, X, out=None):
        if self._matmat_impl is not None:
            return fill_out(self._matmat_impl(X), out)
        return super()._matmat(X, out=out)


class _SparseMatrixLinearOperator(LinearOperator):
    """Wraps a ``csr_array``; ``matvec`` and ``matmat`` are its ``dot``."""

    def __init__(self, A: csr_array):
        self.A = A
        super().__init__(A.dtype, A.shape)

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _matvec(self, x, out=None):
        return self.A.dot(x, out=out)

    def _matmat(self, X, out=None):
        return self.A.dot(X, out=out)


class _DenseMatrixLinearOperator(LinearOperator):
    def __init__(self, A: torch.Tensor):
        self.A = A
        super().__init__(A.dtype, A.shape)

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _matvec(self, x, out=None):
        return fill_out(self.A @ x, out)

    def _rmatvec(self, x, out=None):
        return fill_out(self.A.conj().T @ x, out)


class IdentityOperator(LinearOperator):
    """No-op operator (reference ``linalg.py:392-414``)."""

    def __init__(self, shape, dtype=None):
        super().__init__(dtype, shape)

    def _matvec(self, x, out=None):
        return fill_out(x, out)

    def _rmatvec(self, x, out=None):
        return fill_out(x, out)


def make_linear_operator(A) -> LinearOperator:
    """Matrices, scipy matrices, dense tensors and operators as a
    ``LinearOperator`` (reference ``linalg.py:417-431``)."""
    from .csr import _is_scipy_sparse

    if isinstance(A, LinearOperator):
        return A
    if _is_scipy_sparse(A):
        A = csr_array(A)
    if is_sparse_matrix(A):
        if not isinstance(A, csr_array):
            A = A.tocsr()
        return _SparseMatrixLinearOperator(A)
    if not isinstance(A, torch.Tensor):
        A = as_tensor(A, resolve_device(None))
    return _DenseMatrixLinearOperator(A)


def _get_atol_rtol(b_norm, tol=None, atol=0.0, rtol=1e-5):
    """scipy-compatible tolerance resolution (reference ``linalg.py:454-462``)."""
    rtol = float(tol) if tol is not None else rtol
    if atol is None:
        atol = rtol
    atol = max(float(atol), float(rtol) * float(b_norm))
    return atol, rtol


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, and 0 where den == 0 (no NaN from an exact solve)."""
    zero = den == 0
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


def cg(A, b, x0=None, tol=None, maxiter=None, M=None,
       callback: Optional[Callable] = None, atol=0.0, rtol=1e-5,
       conv_test_iters: int = 25, device=None):
    """Conjugate Gradient solve of ``A x = b`` (scipy-shaped signature,
    reference ``linalg.py:465-535``).  Returns ``(x, iters)``.

    Runs on the device of ``A`` (a ``csr_array`` or dense tensor), else
    of ``b`` when it is a tensor, else on ``device``.  The solve is done
    in ``result_type(A, b)``.  ``callback(x)`` sees every iterate."""
    A_op = make_linear_operator(A)
    dev = getattr(A_op, "device", None)
    if dev is None:
        dev = _solve_device(b, device)
    b = as_tensor(b, dev)
    if b.dim() == 2 and b.shape[1] == 1:
        b = b.reshape(-1)
    if b.dim() != 1 or len(A_op.shape) != 2 or A_op.shape[0] != A_op.shape[1]:
        raise ValueError("cg needs a square operator and a vector b")
    if A_op.dtype is not None:
        b = b.to(find_common_type(A_op.dtype, b.dtype))

    bnrm2 = float(torch.linalg.vector_norm(b))
    atol, _ = _get_atol_rtol(bnrm2, tol, atol, rtol)
    n = b.shape[0]
    if maxiter is None:
        maxiter = n * 10
    maxiter = int(maxiter)
    conv_test_iters = int(conv_test_iters)

    M_op = (IdentityOperator(A_op.shape, dtype=A_op.dtype) if M is None
            else make_linear_operator(M))
    x = (torch.zeros(n, dtype=b.dtype, device=dev) if x0 is None
         else as_tensor(x0, dev, dtype=b.dtype).reshape(-1).clone())
    real_dt = b.real.dtype if b.is_complex() else b.dtype
    # The threshold is squared in the working precision, as the JAX
    # loop does, so both stop at the same iteration.
    atol2 = torch.tensor(atol, dtype=real_dt, device=dev) ** 2

    r = b - A_op.matvec(x)
    p = torch.zeros_like(b)
    rho_old = torch.ones((), dtype=b.dtype, device=dev)
    iters = 0
    while iters < maxiter:
        z = M_op.matvec(r)
        rho = torch.vdot(r, z)
        if iters == 0:
            beta = torch.zeros_like(rho)
        else:
            beta = _safe_div(rho, rho_old)
        p = z + beta * p
        q = A_op.matvec(p)
        alpha = _safe_div(rho, torch.vdot(p, q))
        x = x + alpha * p
        r = r - alpha * q
        rho_old = rho
        iters += 1
        if callback is not None:
            callback(x)
        if iters % conv_test_iters == 0 or iters == maxiter - 1:
            rnorm2 = torch.vdot(r, r).real
            if bool((rnorm2 < atol2).item()):
                break
    return x, iters


def _solve_device(b, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(b, torch.Tensor):
        return b.device
    return resolve_device(None)


__all__ = ["LinearOperator", "IdentityOperator", "make_linear_operator",
           "cg"]
