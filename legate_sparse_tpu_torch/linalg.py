# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Linear operators, the Krylov solvers and sparse norms.

Mirrors ``legate_sparse_tpu/linalg.py``: ``LinearOperator`` (``:48``),
``_SparseMatrixLinearOperator`` (``:153``, with its cached transpose
for ``rmatvec``), ``IdentityOperator`` (``:229``),
``make_linear_operator`` (``:270``), ``cg_axpby`` (``:291``),
``_get_atol_rtol`` (``:319``), ``cg`` (``:588``), ``gmres``
(``:807``, its restart cycle ``_gmres_cycle`` ``:706``), ``bicgstab``
(``:963``, its loop ``_bicgstab_loop`` ``:1008``), ``norm``
(``:1092``) and the scipy fallback of the module ``__getattr__``
(``:1175``).  ``minres``, ``lsqr``, ``lsmr`` and
``differentiable_solve`` live in ``krylov_extra.py``, ``jacobi`` and
``block_jacobi`` in ``precond.py``, ``expm_multiply`` in ``expm.py``,
``eigs``, ``eigsh``, ``lobpcg`` and ``svds`` in ``eigen.py``; all are
importable from here, as in the JAX package.

The JAX package runs each solve as one ``lax.while_loop``.  Here the
loops are Python loops over device tensors with the same iterations:
safe divides, convergence tested only at the JAX package's cadence
(``iters % conv_test_iters == 0`` or the last iteration), the same
returned iteration count, and a device→host sync only at those tests.
A GMRES restart cycle makes no host sync at all: the Givens scalars,
the rotations and the back-substitution stay on the device, and the
outer loop fetches ``[beta, resid]`` once a cycle (``_host_fetch``).

``refine=`` on ``cg``/``gmres`` is mixed-precision iterative
refinement (``_refined_solve``): inner solves over the matrix's
compressed storage one precision rung down (``csr_array.compress``),
full-precision residual corrections between them, one host fetch a
cycle.

Observability, under the JAX package's names (``obs``): ``op.cg``,
``op.gmres`` and ``op.bicgstab`` per call; ``lat.cg.solve.<bucket>``,
``lat.gmres.cycle.<bucket>`` and ``lat.bicgstab.solve.<bucket>``
histograms of host time; spans ``cg``, ``cg.iter`` (each CG
iteration), ``cg.fetch`` (each convergence fetch), ``gmres.cycle``,
``bicgstab`` and ``<solver>.refine`` while tracing is on; and
``transfer.host_sync.{cg_conv,gmres_conv,<solver>_refine}`` at each
fetch.  The JAX package's one-shot CG loop never fetches, so it counts
no ``cg_conv`` (its chunked resilience loop does); the port's CG
fetches at every convergence test and counts each.

With ``settings.engine`` on, an operator over an engine-eligible
``csr_array`` builds the engine's matvec closure when it is made
(``_SparseMatrixLinearOperator._engine_mv``), so the solver loops run
their products through the bucketed plan, bit for bit the plain
csr-rowids product.

Resilience (``settings.resil``, ``resilience/``), at the fetches the
solvers make anyway, adding no host sync: ``cg`` runs in stretches of
``conv_test_iters`` iterations (``_cg_loop(..., site=...)``, the JAX
package's chunked ``_cg_loop_resil``) when a deadline scope, health
detection or a checkpoint scope asks for it (``_resil_solver_active``).
Each stretch is the ``solver.cg.conv`` fault/retry site and re-runs
from its entry state, bit for bit; before it the deadline is checked,
after it the fetched residual feeds the health monitor and the
checkpoint takes ``(x, r, p)`` to the host.  A GMRES restart cycle is
the ``solver.gmres.conv`` site with the same three hooks (the
checkpoint takes ``x``), and ``refine=`` checks the monitor and the
deadline at its refinement fetch.  In a distributed solve a
checkpoint gathers the blocks into whole vectors first, and the ranks
agree on a deadline's expiry.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from .csr import csr_array
from .obs import counters as _obs_counters
from .resilience import checkpoint as _rckpt
from .resilience import deadline as _rdeadline
from .resilience import faults as _rfaults
from .resilience import health as _rhealth
from .resilience import policy as _rpolicy
from .settings import settings as _settings
from .obs import latency as _lat
from .obs import trace as _trace
from .runtime import resolve_device
from .utils import (as_tensor, fill_out, find_common_type,
                    is_sparse_matrix, to_numpy)
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
    """Wraps a ``csr_array``; ``matvec`` and ``matmat`` are its ``dot``,
    ``rmatvec`` that of its conjugate transpose, built on the first call
    and cached (reference ``linalg.py:211-214``).

    With ``settings.engine`` on, construction builds the engine's
    bucketed matvec closure for an eligible matrix (JAX
    ``linalg.py:157-209``), and ``matvec`` runs the solver's products
    through it: bit for bit the plain csr-rowids product, without the
    per-call routing checks of ``dot``."""

    def __init__(self, A: csr_array):
        self.A = A
        self.AT = None
        self._engine_mv = None
        from .settings import settings as _settings

        if _settings.engine:
            from .engine import get_engine

            # The route's "engine on is always safe" contract: a plan
            # build failure must not make a solve raise where the plain
            # dispatch would succeed.
            try:
                self._engine_mv = get_engine().traceable_matvec(A)
            except Exception as e:
                _obs_counters.inc("engine.route.error")
                _trace.event("engine.route.error", op="solver_matvec",
                             error=repr(e)[:200])
        super().__init__(A.dtype, A.shape)

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _matvec(self, x, out=None):
        if (self._engine_mv is not None
                and isinstance(x, torch.Tensor) and x.dim() == 1
                and x.device == self.A.device
                and torch.promote_types(self.A.dtype, x.dtype)
                == self.A.dtype
                and self._engine_fresh()):
            # The dtype gate mirrors engine eligibility: a promoted
            # iterate (an f64 rhs over an f32 matrix) must not be cast
            # down by the closure; it keeps the plain dispatch.
            return fill_out(self._engine_mv(x), out)
        return self.A.dot(x, out=out)

    def _engine_fresh(self) -> bool:
        """The closure read the operands padded at construction; after
        an in-place mutation of ``A`` (which clears ``A._engine_pack``)
        it would solve the OLD matrix, so the live dispatch serves."""
        cached = self.A._engine_pack
        return (cached is not None
                and cached[1] is getattr(self._engine_mv, "pack", None))

    def _matmat(self, X, out=None):
        return self.A.dot(X, out=out)

    def _rmatvec(self, x, out=None):
        if self.AT is None:
            self.AT = self.A.T.conj(copy=False)
        return self.AT.dot(x, out=out)


def _promoted(A: torch.Tensor, x: torch.Tensor):
    dt = torch.promote_types(A.dtype, x.dtype)
    return A.to(dt), x.to(dt)


class _DenseMatrixLinearOperator(LinearOperator):
    """A dense tensor; a vector of another dtype is promoted with it, as
    ``jnp``'s ``@`` does."""

    def __init__(self, A: torch.Tensor):
        self.A = A
        super().__init__(A.dtype, A.shape)

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _matvec(self, x, out=None):
        A, x = _promoted(self.A, x)
        return fill_out(A @ x, out)

    def _matmat(self, X, out=None):
        A, X = _promoted(self.A, X)
        return fill_out(A @ X, out)

    def _rmatvec(self, x, out=None):
        A, x = _promoted(self.A, x)
        return fill_out(A.conj().T @ x, out)


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


def cg_axpby(y, x, a, b, isalpha: bool = True, negate: bool = False):
    """``y = (±a/b)·x + y`` (``isalpha``) or ``y = x + (±a/b)·y``
    (reference ``linalg.py:291-316``).  A numpy ``y`` is updated in
    place and returned, as in the JAX package; a tensor ``y`` is left
    as it is and the result comes back new.  The work runs on the
    device of the first tensor among the operands, else on the default
    device."""
    dev = next((t.device for t in (y, x, a, b)
                if isinstance(t, torch.Tensor)), None)
    if dev is None:
        dev = resolve_device(None)
    yt, xt, at, bt = (as_tensor(v, dev) for v in (y, x, a, b))
    coef = at / bt
    if negate:
        coef = -coef
    result = coef * xt + yt if isalpha else xt + coef * yt
    if isinstance(y, np.ndarray):
        np.copyto(y, to_numpy(result).astype(y.dtype, copy=False))
        return y
    return result


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


# The process group over which a distributed solve sums its inner
# products and norms, and the count and bytes of the all-reduces it made
# (``reduce_over``); unset on one device.
_REDUCE = contextvars.ContextVar("legate_sparse_tpu_torch_reduce",
                                default=None)


@contextlib.contextmanager
def reduce_over(group):
    """Within the block, the solvers' vectors are one rank's blocks of
    vectors spread over ``group`` (``parallel.dist_csr``'s solvers):
    every inner product and norm is all-reduced over it, as GSPMD
    lowers the JAX package's to a ``psum``.  Yields the dict of
    ``calls`` and ``bytes`` of those all-reduces."""
    stats = {"calls": 0, "bytes": 0}
    token = _REDUCE.set((group, stats))
    try:
        yield stats
    finally:
        _REDUCE.reset(token)


def outside_reductions(fn: Callable) -> Callable:
    """``fn`` run with no ``reduce_over`` scope: a caller's
    preconditioner or callback inside a distributed solve works on this
    rank's vectors alone, and a solve it runs there (an inner ``cg`` on
    the rank's block) reduces nothing over the ranks."""
    def run(*args, **kwargs):
        token = _REDUCE.set(None)
        try:
            return fn(*args, **kwargs)
        finally:
            _REDUCE.reset(token)
    return run


def _global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``, a sum over this rank's rows, summed over the ranks of a
    distributed solve (one ``all_reduce``); ``t`` itself on one device.
    The one door of the solvers' global reductions: ``_vdot``,
    ``_norm`` and the eigensolvers' projections."""
    scope = _REDUCE.get()
    if scope is None:
        return t
    import torch.distributed as dist

    from .obs import comm as _comm

    group, stats = scope
    dist.all_reduce(t, group=group)
    stats["calls"] += 1
    stats["bytes"] += _comm.psum_bytes(t.numel(), t.element_size(),
                                       dist.get_world_size(group))
    return t


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.vdot``: conjugates ``a``, promotes mixed dtypes (an
    operator may hand back another dtype than the iterate's); summed
    over the ranks of a distributed solve."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return _global_sum(torch.vdot(a, b))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """``vector_norm(v)``; over the ranks of a distributed solve, the
    root of the all-reduced sum of squares."""
    if _REDUCE.get() is None:
        return torch.linalg.vector_norm(v)
    return torch.sqrt(_vdot(v, v).real)


def _solve_device(b, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(b, torch.Tensor):
        return b.device
    return resolve_device(None)


def _setup(A, b, M, device, name: str, square: bool = True):
    """The shared start of a solve: the operator, ``b`` as a 1-D tensor
    on the operator's device (else ``b``'s, else ``device``) promoted to
    ``result_type(A, b)`` (autograd history kept), ``‖b‖`` before the
    promotion (as the JAX package takes it), ``M`` (the identity when
    None) and the device."""
    A_op = make_linear_operator(A)
    dev = getattr(A_op, "device", None)
    if dev is None:
        dev = _solve_device(b, device)
    b = as_tensor(b, dev)
    if b.dim() == 2 and b.shape[1] == 1:
        b = b.reshape(-1)
    if (b.dim() != 1 or len(A_op.shape) != 2
            or (square and A_op.shape[0] != A_op.shape[1])
            or b.shape[0] != A_op.shape[0]):
        raise ValueError(f"{name} needs a {'square ' if square else ''}"
                         f"operator and a vector b of its rows, got "
                         f"{A_op.shape} and {tuple(b.shape)}")
    bnrm2 = float(_norm(b.detach()))
    if A_op.dtype is not None:
        b = b.to(find_common_type(A_op.dtype, b.dtype))
    M_op = (IdentityOperator(A_op.shape, dtype=A_op.dtype) if M is None
            else make_linear_operator(M))
    return A_op, b, bnrm2, M_op, dev


def _x0(x0, b: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """The start vector: ``x0`` as a new 1-D tensor in ``b``'s dtype and
    on its device, else zeros of length ``n`` (default ``b``'s)."""
    if x0 is None:
        return torch.zeros(b.shape[0] if n is None else n, dtype=b.dtype,
                           device=b.device)
    return as_tensor(x0, b.device, dtype=b.dtype).reshape(-1).clone()


# ---------------- mixed-precision iterative refinement ----------------

_REFINE_AUTO_CYCLES = 12   # "auto": the outer correction cycle budget
_REFINE_INNER_RTOL = 1e-2  # an inner solve's residual reduction target


def _refine_inner_operator(A) -> csr_array:
    """The inner operator of ``refine=`` (reference ``linalg.py:336-360``):
    the matrix one precision rung down, f64 values to f32 and f32 values
    to bf16, with int16 column indices where the width fits
    (``csr_array.compress``).  Raises for an operand refinement cannot
    serve: a dense or callable operator, or storage that is already
    low-precision."""
    if is_sparse_matrix(A) and not isinstance(A, csr_array):
        A = A.tocsr()
    if not isinstance(A, csr_array):
        raise ValueError(
            "refine= needs a sparse-matrix operand (the inner solve runs "
            f"over compressed csr_array storage); got {type(A).__name__}")
    if A.dtype == torch.float64:
        return A.compress(values="float32")
    if A.dtype == torch.float32:
        return A.compress()
    raise ValueError(
        f"refine= serves float32/float64 systems (got {A.dtype}: storage "
        "is already low-precision — solve it directly)")


def _refine_cycles(refine) -> int:
    if refine == "auto":
        return _REFINE_AUTO_CYCLES
    cycles = int(refine)
    if cycles <= 0:
        raise ValueError(f"refine= must be 'auto' or a positive cycle "
                         f"count, got {refine!r}")
    return cycles


def _refined_solve(solver: str, inner_solve: Callable, A_op, A_in,
                   b: torch.Tensor, x: torch.Tensor, atol: float,
                   maxiter: int, cycles: int):
    """The iterative-refinement loop behind ``cg``/``gmres``
    ``refine=`` (reference ``linalg.py:372-424``): the residual
    ``r = b - A x`` in full precision against the caller's matrix, an
    inner solve for the correction over the compressed operator
    ``A_in`` in f32 vectors to ``_REFINE_INNER_RTOL`` of ``|r|`` (the
    grade narrow storage can deliver), then ``x += d`` in full
    precision.  Convergence is judged on the true residual, so the
    refined solve meets the ``atol`` the unrefined solve would.

    One host fetch a cycle (``_host_fetch`` of ``|r|``), counted as
    ``transfer.host_sync.<solver>_refine``; with ``settings.resil`` the
    health monitor and the deadline ride it (site
    ``solver.<solver>.refine``).  Returns ``(x, total inner
    iterations)``."""
    site = f"solver.{solver}.refine"
    monitor = _rhealth.Monitor(site) if _settings.resil else None
    inner_dt = torch.float32 if b.dtype == torch.float64 else b.dtype
    total = 0
    rn = None
    with _trace.span(solver + ".refine", n=int(b.shape[0]), cycles=cycles,
                     inner_dtype=str(A_in.dtype).replace("torch.", "")
                     ) as sp:
        for _ in range(cycles):
            r = b - A_op.matvec(x)
            rn = _host_fetch(_norm(r))[0]
            _obs_counters.inc(f"transfer.host_sync.{solver}_refine")
            if monitor is not None:
                monitor.observe(rn, total, partial=x)
                _deadline_check(site, total, rn, x)
            if rn < atol or total >= maxiter:
                break
            d, it = inner_solve(A_in, r.to(inner_dt),
                                max(atol, _REFINE_INNER_RTOL * rn),
                                maxiter - total)
            total += max(int(it), 1)
            x = x + d.to(b.dtype)
        if sp is not None:
            sp.set(iters=total, resid=rn)
    return x, total


def _refine_args_ok(solver: str, M, callback) -> None:
    if M is not None or callback is not None:
        raise ValueError(
            f"{solver}: refine= composes with neither M= nor callback= — "
            "inner solves run over the compressed operator without the "
            "outer preconditioner/observer")


def _cg_stretch(A_mv: Callable, M_mv: Callable, state, limit: int,
                maxiter: int, conv_test_iters: int, atol2: torch.Tensor,
                callback: Optional[Callable] = None, hold: bool = False):
    """CG iterations from ``state = (x, r, p, rho_old, iters)`` up to
    iteration ``limit``: the JAX package's CG body (``linalg.py:430-469``),
    shared by the plain solve and the stretches of the
    resilient one.  At each convergence test (``iters % conv_test_iters
    == 0`` or ``iters == maxiter - 1``) one host fetch decides.  With
    ``hold`` the fetch takes ``[converged, |r|²]`` and the test at
    ``limit`` itself is left unfetched, for the caller.  Nothing is
    updated in place, so ``state`` can be run again.  Returns ``(state,
    held stats or None, fetched [converged, |r|²] or None)``."""
    x, r, p, rho_old, iters = state
    real_dt = atol2.dtype
    stats = fetched = None
    while iters < limit:
        with _trace.span("cg.iter"):
            z = M_mv(r)
            rho = _vdot(r, z)
            if iters == 0:
                beta = torch.zeros_like(rho)
            else:
                beta = _safe_div(rho, rho_old)
            p = z + beta * p
            q = A_mv(p)
            alpha = _safe_div(rho, _vdot(p, q))
            x = x + alpha * p
            r = r - alpha * q
            rho_old = rho
            iters += 1
            if callback is not None:
                callback(x)
            if iters % conv_test_iters == 0 or iters == maxiter - 1:
                rnorm2 = _vdot(r, r).real
                if not hold:
                    if _cg_fetch(rnorm2 < atol2)[0]:
                        break
                    continue
                stats = torch.stack([(rnorm2 < atol2).to(real_dt), rnorm2])
                if iters == limit:
                    break
                fetched = _cg_fetch(stats)
                stats = None
                if fetched[0]:
                    break
    return (x, r, p, rho_old, iters), stats, fetched


def _cg_fetch(t: torch.Tensor) -> List[float]:
    """``_host_fetch`` of a CG convergence test: counted as
    ``transfer.host_sync.cg_conv`` and, while tracing, inside a
    ``cg.fetch`` span."""
    with _trace.span("cg.fetch"):
        out = _host_fetch(t)
    _obs_counters.handle("transfer.host_sync.cg_conv").inc()
    return out


def _cg_loop(A_mv: Callable, M_mv: Callable, b: torch.Tensor,
             x: torch.Tensor, atol, maxiter: int, conv_test_iters: int,
             callback: Optional[Callable] = None,
             site: Optional[str] = None, r0_mv: Optional[Callable] = None):
    """Preconditioned CG from ``x`` (the JAX package's ``_cg_loop`` and,
    with ``site``, its chunked ``_cg_loop_resil``, ``:514-575``).
    ``atol`` is a float or a 0-d tensor on the device; the threshold is
    squared in the working precision, as the JAX loop does, so both stop
    at the same iteration.  ``r0_mv`` computes the first residual's
    product (the distributed solver's goes through the ``dist.spmv``
    site).

    With ``site`` the iterations run in stretches of ``conv_test_iters``
    (the JAX package's chunks), each ``site``'s fault/retry unit
    (``policy.run``), re-run from its entry state on a retry, so a
    retried solve is bit for bit the clean one: the deadline is checked
    before a stretch, its test's ``[converged, |r|²]`` passes
    ``fault_point(site)`` (a ``nonfinite`` fault poisons ``|r|²``) and is
    fetched once, the residual feeds the health monitor, and a
    checkpoint scope snapshots ``(x, r, p)``.  The fetches, and so the
    host syncs, are the plain loop's."""
    real_dt = b.dtype.to_real()
    atol2 = torch.as_tensor(atol, dtype=real_dt, device=b.device) ** 2
    r = b - (A_mv if r0_mv is None else r0_mv)(x)
    p = torch.zeros_like(b)
    rho_old = torch.ones((), dtype=b.dtype, device=b.device)
    state = (x, r, p, rho_old, 0)
    if site is None:
        state, _, _ = _cg_stretch(A_mv, M_mv, state, maxiter, maxiter,
                                  conv_test_iters, atol2, callback)
        return state[0], state[4]
    step = max(int(conv_test_iters), 1)
    monitor = _rhealth.Monitor(site)
    ckpt = _rckpt.current()
    lat_name = "lat.cg.chunk." + _lat.shape_bucket(b.shape[0])
    it, resid = 0, None
    while it < maxiter:
        _deadline_check(site, it, resid, state[0])
        limit = min(it + step, maxiter)

        def attempt(state=state, limit=limit):
            st, stats, fetched = _cg_stretch(
                A_mv, M_mv, state, limit, maxiter, conv_test_iters, atol2,
                callback, hold=True)
            return st, _rfaults.fault_point(site, stats), fetched

        with _lat.timer(lat_name):
            state, stats, fetched = _rpolicy.run(site, attempt)
        if stats is not None:
            fetched = _cg_fetch(stats)
        it = state[4]
        done = False
        if fetched is not None:
            done = bool(fetched[0])
            # A poisoned (NaN) |r|² stays NaN for the monitor.
            resid = math.sqrt(fetched[1]) if fetched[1] >= 0 else fetched[1]
            monitor.observe(resid, it, partial=state[0])
        if ckpt is not None and not done:
            _ckpt_save(ckpt, it, state[:3])
        if done:
            break
    return state[0], state[4]


def _resil_solver_active() -> bool:
    """Run ``cg`` in its resilient stretches?  The master switch AND
    something that needs a host decision at the fetches: a deadline
    scope, health detection, or a checkpoint scope (JAX
    ``linalg.py:502``).  With ``settings.resil`` off, one flag read."""
    return _settings.resil and (
        _rdeadline.current() is not None or _rhealth.active()
        or _rckpt.active())


def _deadline_check(site: str, iterations: int, residual, partial) -> None:
    """``deadline.raise_if_expired`` at a solver's cadence point.  In a
    distributed solve the ranks agree first (one all-reduce of the
    verdict): a rank whose own clock ran out alone must not leave the
    others in a collective."""
    d = _rdeadline.current()
    if d is None:
        return
    scope = _REDUCE.get()
    if scope is None:
        _rdeadline.raise_if_expired(site, iterations, residual, partial)
        return
    import torch.distributed as dist

    flag = torch.tensor([float(d.expired())], device=partial.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=scope[0])
    if _host_fetch(flag)[0]:
        _rdeadline.expire(site, iterations, residual, partial)


def _ckpt_save(ckpt, iterations: int, arrays) -> None:
    """Hand ``arrays`` to the checkpoint when its cadence says so; in a
    distributed solve each is first all-gathered into the whole padded
    vector, so any survivor of a lost rank holds the full iterate."""
    if not ckpt.due(iterations):
        return
    scope = _REDUCE.get()
    if scope is not None:
        import torch.distributed as dist

        group = scope[0]
        size = dist.get_world_size(group)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        gathered = []
        for a in arrays:
            out = a.new_empty((size * a.shape[0],) + tuple(a.shape[1:]))
            gather(out, a.contiguous(), group=group)
            gathered.append(out)
        arrays = gathered
    ckpt.save(iterations, arrays)


def cg(A, b, x0=None, tol=None, maxiter=None, M=None,
       callback: Optional[Callable] = None, atol=0.0, rtol=1e-5,
       conv_test_iters: int = 25, refine=None, device=None):
    """Conjugate Gradient solve of ``A x = b`` (scipy-shaped signature,
    reference ``linalg.py:465-535``).  Returns ``(x, iters)``.

    Runs on the device of ``A`` (a ``csr_array`` or dense tensor), else
    of ``b`` when it is a tensor, else on ``device``.  The solve is done
    in ``result_type(A, b)``.  ``callback(x)`` sees every iterate.

    ``refine="auto"`` (or a positive cycle count) runs mixed-precision
    iterative refinement (``_refined_solve``): inner CG solves over
    ``A.compress()`` (bf16 values under an f32 system, f32 under f64,
    int16 indices where they fit), full-precision corrections between
    them, to the same ``atol`` the unrefined solve meets."""
    A_op, b, bnrm2, M_op, _ = _setup(A, b, M, device, "cg")
    atol, _ = _get_atol_rtol(bnrm2, tol, atol, rtol)
    n = b.shape[0]
    if maxiter is None:
        maxiter = n * 10
    x = _x0(x0, b)
    if refine is not None:
        _refine_args_ok("cg", M, callback)
        _obs_counters.handle("op.cg").inc()

        def inner(A_in, r, inner_atol, budget):
            return cg(A_in, r, atol=inner_atol, rtol=0.0, maxiter=budget,
                      conv_test_iters=conv_test_iters)

        return _refined_solve("cg", inner, A_op, _refine_inner_operator(A),
                              b, x, atol, int(maxiter),
                              _refine_cycles(refine))
    _obs_counters.handle("op.cg").inc()
    if callback is not None:
        return _cg_loop(A_op.matvec, M_op.matvec, b, x, atol, int(maxiter),
                        int(conv_test_iters), callback)
    with _trace.span("cg", n=n, maxiter=int(maxiter)) as sp:
        with _lat.timer("lat.cg.solve." + _lat.shape_bucket(n)):
            x, iters = _cg_loop(
                A_op.matvec, M_op.matvec, b, x, atol, int(maxiter),
                int(conv_test_iters),
                site="solver.cg.conv" if _resil_solver_active() else None)
        if sp is not None:
            # Priced after the span's interval ends.
            sp.stop().set(iters=iters)
            src = getattr(A_op, "A", None)
            if isinstance(src, csr_array):
                sp.set(nnz=src.nnz * iters,
                       bytes=src.spmv_traffic_bytes(b) * iters,
                       flops=2 * src.nnz * iters)
    return x, iters


def _host_fetch(t: torch.Tensor) -> List[float]:
    """The values of ``t`` on the host: the device→host transfers of
    the solvers — ``gmres`` once a restart cycle (``[beta, resid]``) and
    once at each suspected convergence (the true residual's norm),
    ``cg`` at each convergence test, ``refine=`` once a cycle; the
    eigensolvers once a try.  Each caller counts its own
    ``transfer.host_sync.*``."""
    return t.reshape(-1).tolist()


def _gmres_cycle(A_mv: Callable, M_mv: Callable, x: torch.Tensor,
                 b: torch.Tensor, restart: int):
    """One restart cycle with no host sync (reference ``linalg.py:706-804``):
    modified Gram-Schmidt Arnoldi, each new Hessenberg column rotated by
    the accumulated Givens rotations as it is made, back-substitution
    on the (restart, restart) triangle (a zero pivot gives ``y_i = 0``,
    ``lstsq``'s minimum-norm answer after a happy breakdown), then
    ``x + M(y V)``.  Every scalar stays a 0-d tensor on the device.
    Returns ``(x_new, stats)``, ``stats = [beta, resid]``: the residual
    norm at the cycle's start and the least-squares residual at its end."""
    from .krylov_extra import _givens

    dtype = b.dtype
    rdt = dtype.to_real()
    dev = b.device
    n = b.shape[0]
    r = b - A_mv(x)
    beta = _norm(r).to(rdt)
    V = torch.zeros((restart + 1, n), dtype=dtype, device=dev)
    V[0] = torch.where(beta > 0, r / beta.to(dtype), r)
    R = torch.zeros((restart, restart), dtype=dtype, device=dev)
    g = torch.zeros((restart + 1,), dtype=dtype, device=dev)
    g[0] = beta
    cs = torch.zeros((restart,), dtype=dtype, device=dev)
    sn = torch.zeros((restart,), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for j in range(restart):
        w = A_mv(M_mv(V[j]))
        h = torch.zeros((restart + 1,), dtype=dtype, device=dev)
        for i in range(j + 1):
            hij = _vdot(V[i], w)
            w = w - hij * V[i]
            h[i] = hij
        hnorm = _norm(w)
        h[j + 1] = hnorm
        V[j + 1] = torch.where(hnorm > 1e-30, w / hnorm.to(dtype), w)
        for i in range(j):
            new_i = cs[i] * h[i] + sn[i] * h[i + 1]
            h[i + 1] = -sn[i].conj() * h[i] + cs[i].conj() * h[i + 1]
            h[i] = new_i
        c, s = _givens(h[j], h[j + 1])
        cs[j] = c
        sn[j] = s
        h[j] = c * h[j] + s * h[j + 1]
        h[j + 1] = zero
        g[j + 1] = -s.conj() * g[j]
        g[j] = c * g[j]
        R[:, j] = h[:restart]
    y = torch.zeros((restart,), dtype=dtype, device=dev)
    for i in range(restart - 1, -1, -1):
        num = g[i] - torch.dot(R[i], y)
        d = R[i, i]
        pivot = d == 0
        y[i] = torch.where(pivot, torch.zeros_like(num),
                           num / torch.where(pivot, torch.ones_like(d), d))
    x_new = x + M_mv(y @ V[:restart])
    resid = g[restart].abs().to(rdt)
    return x_new, torch.stack([beta, resid])


def gmres(A, b, x0=None, tol=None, restart=None, maxiter=None, M=None,
          callback=None, restrt=None, atol=0.0, callback_type=None,
          rtol=1e-5, refine=None, device=None):
    """Restarted GMRES (scipy/cupy-shaped signature, reference
    ``linalg.py:807-951``).  Returns ``(x, iters)``; ``iters`` grows by
    ``restart`` a cycle, as the JAX loop counts.

    A cycle (``_gmres_cycle``) makes no host sync; the outer loop fetches
    ``[beta, resid]`` once a cycle: ``beta < atol`` keeps ``x`` and
    stops, and ``resid < atol`` is confirmed by one fetch of the true
    residual's norm.  ``callback(x)`` sees the iterate after every
    cycle, or ``callback_type="pr_norm"`` its relative residual norm.
    ``refine=`` runs mixed-precision iterative refinement with inner
    restarted GMRES solves over the compressed operator, as ``cg``'s."""
    if restrt is not None:
        if restart:
            raise ValueError("gmres: give restart or restrt, not both")
        restart = restrt
    A_op, b, bnrm2, M_op, _ = _setup(A, b, M, device, "gmres")
    n = b.shape[0]
    atol, _ = _get_atol_rtol(bnrm2, tol, atol, rtol)
    if maxiter is None:
        maxiter = n * 10
    restart = min(int(20 if restart is None else restart), n)
    x = _x0(x0, b)
    if refine is not None:
        _refine_args_ok("gmres", M, callback)
        _obs_counters.handle("op.gmres").inc()

        def inner(A_in, r, inner_atol, budget):
            return gmres(A_in, r, atol=inner_atol, rtol=0.0,
                         restart=restart, maxiter=budget)

        return _refined_solve("gmres", inner, A_op,
                              _refine_inner_operator(A), b, x, atol,
                              int(maxiter), _refine_cycles(refine))
    _obs_counters.handle("op.gmres").inc()
    return _gmres_loop(A_op.matvec, M_op.matvec, b, x, atol, restart,
                       int(maxiter), callback, callback_type, bnrm2)


def _gmres_loop(A_mv: Callable, M_mv: Callable, b: torch.Tensor,
                x: torch.Tensor, atol: float, restart: int, maxiter: int,
                callback: Optional[Callable] = None, callback_type=None,
                bnrm2: float = 1.0):
    """The restart cycles of ``gmres`` from ``x`` (reference
    ``linalg.py:807-951``), one fetch of ``[beta, resid]`` a cycle.
    With ``settings.resil`` a cycle is the ``solver.gmres.conv``
    fault/retry site (re-run from its entry ``x``, bit for bit), the
    deadline is checked before it, the fetch feeds the health monitor,
    and a checkpoint scope snapshots ``x`` after it (JAX
    ``linalg.py:890-937``).  Returns ``(x, iters)``."""
    site = "solver.gmres.conv"
    conv = _obs_counters.handle("transfer.host_sync.gmres_conv")
    lat_name = "lat.gmres.cycle." + _lat.shape_bucket(b.shape[0])
    resil = _settings.resil
    monitor = _rhealth.Monitor(site) if resil else None
    ckpt = _rckpt.current() if resil else None
    resid_f = None
    iters = 0
    while iters < maxiter:
        if resil:
            _deadline_check(site, iters, resid_f, x)
        with _lat.timer(lat_name), \
                _trace.span("gmres.cycle", restart=restart,
                            iters_done=iters):
            if resil:
                def cycle(x=x):
                    xn, st = _gmres_cycle(A_mv, M_mv, x, b, restart)
                    return xn, _rfaults.fault_point(site, st)

                x_new, stats = _rpolicy.run(site, cycle)
            else:
                x_new, stats = _gmres_cycle(A_mv, M_mv, x, b, restart)
            beta_f, resid_f = _host_fetch(stats)
            conv.inc()
            if monitor is not None:
                # A non-finite cycle-start norm is the earliest sign;
                # else the cycle-end least-squares residual is judged.
                monitor.observe(beta_f if not math.isfinite(beta_f)
                                else resid_f, iters + restart,
                                partial=x_new)
        if beta_f < atol:
            break                  # converged at the cycle's start: keep x
        x = x_new
        iters += restart
        if ckpt is not None:
            # x alone restarts GMRES: the Arnoldi seed is its state.
            _ckpt_save(ckpt, iters, (x,))
        if callback is not None:
            if callback_type == "pr_norm":
                callback(_host_fetch(_norm(b - A_mv(x)))[0] / bnrm2)
            else:
                callback(x)
        # The Givens estimate equals the true residual's norm only in
        # exact arithmetic: confirm on the real residual, so that drift
        # in the Gram-Schmidt basis cannot fake convergence.
        if resid_f < atol:
            conv.inc()
            if _host_fetch(_norm(b - A_mv(x)))[0] < atol:
                break
    return x, iters


def _bicgstab_step(A_mv: Callable, M_mv: Callable, state, first: bool):
    """One BiCGSTAB iteration on ``(x, r, rtilde, p, v, rho, alpha,
    omega)`` (reference ``_bicgstab_body``, ``linalg.py:963-994``)."""
    x, r, rtilde, p, v, rho_prev, alpha, omega = state
    rho = _vdot(rtilde, r)
    beta = _safe_div(rho, rho_prev) * _safe_div(alpha, omega)
    p = r if first else r + beta * (p - omega * v)
    phat = M_mv(p)
    v = A_mv(phat)
    alpha = _safe_div(rho, _vdot(rtilde, v))
    s = r - alpha * v
    shat = M_mv(s)
    t = A_mv(shat)
    omega = _safe_div(_vdot(t, s), _vdot(t, t))
    x = x + alpha * phat + omega * shat
    r = s - omega * t
    return (x, r, rtilde, p, v, rho, alpha, omega)


def bicgstab(A, b, x0=None, tol=None, maxiter=None, M=None, callback=None,
             atol=0.0, rtol=1e-5, conv_test_iters: int = 25, device=None):
    """BiCGSTAB solve of ``A x = b`` (scipy-shaped signature, reference
    ``linalg.py:1035-1089``).  Returns ``(x, iters)``.

    Converged when ``|r|² < atol²`` at ``iters % conv_test_iters == 0``
    or ``iters == maxiter - 1``; with a ``callback`` (it sees every
    iterate) the test runs every iteration, as the JAX package's
    callback path does."""
    A_op, b, bnrm2, M_op, _ = _setup(A, b, M, device, "bicgstab")
    atol, _ = _get_atol_rtol(bnrm2, tol, atol, rtol)
    n = b.shape[0]
    maxiter = int(n * 10 if maxiter is None else maxiter)
    conv = 1 if callback is not None else int(conv_test_iters)
    _obs_counters.handle("op.bicgstab").inc()
    if callback is not None:
        return _bicgstab_loop(A_op.matvec, M_op.matvec, b, _x0(x0, b), atol,
                              maxiter, conv, callback)
    with _lat.timer("lat.bicgstab.solve." + _lat.shape_bucket(n)), \
            _trace.span("bicgstab", n=n, maxiter=maxiter) as sp:
        x, iters = _bicgstab_loop(A_op.matvec, M_op.matvec, b, _x0(x0, b),
                                  atol, maxiter, conv)
        if sp is not None:
            sp.set(iters=iters)
    return x, iters


def _bicgstab_loop(A_mv: Callable, M_mv: Callable, b: torch.Tensor,
                   x: torch.Tensor, atol, maxiter: int, conv_test_iters: int,
                   callback: Optional[Callable] = None):
    """Preconditioned BiCGSTAB from ``x`` (reference ``_bicgstab_loop``,
    ``linalg.py:1008``); converged when ``|r|² < atol²`` at ``iters %
    conv_test_iters == 0`` or ``iters == maxiter - 1``.  Returns
    ``(x, iters)``."""
    atol2 = torch.tensor(atol, dtype=b.dtype.to_real(),
                         device=b.device) ** 2
    r = b - A_mv(x)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    state = (x, r, r, torch.zeros_like(b), torch.zeros_like(b), one, one,
             one)
    iters = 0
    while iters < maxiter:
        state = _bicgstab_step(A_mv, M_mv, state, iters == 0)
        iters += 1
        if callback is not None:
            callback(state[0])
        if iters % conv_test_iters == 0 or iters == maxiter - 1:
            r = state[1]
            if bool((_vdot(r, r).real < atol2).item()):
                break
    return state[0], iters


def norm(A, ord=None, axis=None):
    """Sparse matrix and vector norms (``scipy.sparse.linalg.norm``,
    reference ``linalg.py:1092-1165``).

    Matrix norms (``axis=None``) come back as floats: Frobenius
    (default, ``'fro'``), 1 / -1 (max / min absolute column sum), inf /
    -inf (max / min absolute row sum), and 2, which scipy computes on
    the host (it needs an SVD).  ``axis=0``/``1`` give per-column /
    per-row vector norms as a tensor on the matrix's device: ord
    None/2 (Euclidean), 1, inf, -inf (implicit zeros count) and 0 (the
    count of nonzero values, in the values' inexact dtype)."""
    if not is_sparse_matrix(A):
        raise TypeError("input is not a sparse matrix")
    A = A.tocsr() if A.format != "csr" else A
    if A.shape[0] == 0 or A.shape[1] == 0:
        raise ValueError("zero-size array to reduction operation")
    if A.nnz and not A.has_canonical_format:
        A.sum_duplicates()

    def absA():
        return A._with_data(A.data.abs())

    if axis is None:
        if ord in (None, "fro", "f"):
            return float(torch.sqrt(torch.sum(A.data.abs() ** 2)))
        if ord == 1:
            return float(torch.max(absA().sum(axis=0)))
        if ord == -1:
            return float(torch.min(absA().sum(axis=0)))
        if ord == math.inf:
            return float(torch.max(absA().sum(axis=1)))
        if ord == -math.inf:
            return float(torch.min(absA().sum(axis=1)))
        if ord == 2:
            import scipy.sparse.linalg as _ssl

            return float(_ssl.norm(A.toscipy(), ord=2))
        raise ValueError(f"Invalid norm order {ord!r} for matrices")

    if axis not in (0, 1, -1, -2):
        raise ValueError(f"invalid axis {axis}")
    axis = axis % 2
    if ord in (None, 2):
        sq = A._with_data(A.data * A.data.conj())
        return torch.sqrt(sq.sum(axis=axis).real)
    if ord == 1:
        return absA().sum(axis=axis)
    if ord == math.inf:
        return absA().max(axis=axis)
    if ord == -math.inf:
        # A row or column with fewer stored entries than its length has
        # an implicit zero, so its minimum is 0.
        counts = A.getnnz(axis=axis)
        m = absA().min(axis=axis)
        return torch.where(counts < A.shape[axis],
                           torch.clamp_max(m, 0.0), m)
    if ord == 0:
        nz = A._with_data((A.data != 0).to(
            torch.promote_types(A.dtype, torch.float32)))
        return nz.sum(axis=axis)
    raise ValueError(f"Invalid norm order {ord!r} for vectors")


from .eigen import eigs, eigsh, lobpcg, svds  # noqa: E402
from .expm import expm_multiply  # noqa: E402
from .krylov_extra import (differentiable_solve, lsmr, lsqr,  # noqa: E402
                           minres)
from .precond import block_jacobi, jacobi  # noqa: E402


def __getattr__(name):
    """``scipy.sparse.linalg``'s names that have no port of their own
    (``spsolve``, ``splu``, ``expm``, ``tfqmr``, ...): scipy on the
    host, with this package's arrays and tensors converted at the
    boundary (reference ``linalg.py:1175-1194``)."""
    import scipy.sparse.linalg as _ssl

    from .coverage import scipy_fallback

    try:
        if name.startswith("_"):       # scipy's module internals stay its own
            raise AttributeError(name)
        value = getattr(_ssl, name)
    except AttributeError:
        raise AttributeError(
            "module 'legate_sparse_tpu_torch.linalg' has no attribute "
            f"{name!r}") from None
    if callable(value) and not isinstance(value, type):
        value = scipy_fallback(value, f"linalg.{name}")
    globals()[name] = value        # one wrapper, a stable identity
    return value


__all__ = ["LinearOperator", "IdentityOperator", "make_linear_operator",
           "bicgstab", "block_jacobi", "cg", "cg_axpby",
           "differentiable_solve", "eigs", "eigsh", "expm_multiply",
           "gmres", "jacobi", "lobpcg", "lsmr", "lsqr", "minres", "norm",
           "svds"]
