# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Sparse eigensolvers on the operator's device: ``eigs``, ``eigsh``,
``lobpcg``, ``svds``.

Mirrors ``legate_sparse_tpu/eigen.py`` function by function, in its
order: the helpers (``_operator_parts`` ``:68``, ``_complex_matvec``
``:92``, ``_restart_direction`` ``:105``, ``_outer_atol`` ``:121``,
``_validate_be_k`` ``:127``, ``_require_real_sigma`` ``:138``,
``_escalation_params`` ``:146``, ``_require_converged`` ``:158``), the
shift-invert inner solves (``_shift_invert_op`` ``:184``,
``_probe_inverse`` ``:227``, ``_check_original_residuals`` ``:245``),
the B-inner Lanczos of the generalized modes (``_lanczos_general``
``:279``, ``_general_lanczos_drive`` ``:448``, ``_eigsh_generalized``
``:489``, ``_eigsh_generalized_si`` ``:548``), ``_lanczos`` ``:629``,
``_lanczos_eigsh`` ``:682``, ``eigsh`` ``:730``, ``_block_seed``
``:928``, ``lobpcg`` ``:947``, ``svds`` ``:1105``, ``_arnoldi``
``:1186``, ``_select_ritz`` ``:1235``, ``eigs`` ``:1253``,
``_arnoldi_eigs`` ``:1370`` and the non-symmetric shift-invert and
generalized drivers (``:1415-1571``).

The JAX package runs each Lanczos or Arnoldi try as one ``lax.scan``.
Here a try is a Python loop over device tensors that makes no host
synchronisation between its matvecs: the recurrence scalars stay 0-d
tensors, breakdown flags are set with ``torch.where``, and the host
fetches the try's ``alphas``/``betas`` (Arnoldi: its Hessenberg) and
flags once, through ``linalg._host_fetch``, to solve the small
projected problem.  Each step reorthogonalises against the rows
``V[:j+1]`` set so far (the scan reads all ``m`` rows, zero past
``j``: the same sums, half the bytes).  The scan draws a breakdown
restart direction at every step (``_restart_direction``, ``:105``) and
keeps it only where a step broke down; here it is drawn only there,
after the fetch, and the steps after it run again (one fetch more per
breakdown), so a step reorthogonalises one vector, not two.  The
restart draws come from a ``torch.Generator`` on the operator's device
seeded from the JAX package's key (7 for Lanczos, 11 for Arnoldi, 23
for the generalized Lanczos, which draws every step as the scan does)
and the step, so they differ from the JAX package's draws; they
matter only at a breakdown.  Inner solves (the shift-invert and
generalized modes) run the port's ``_minres_loop``,
``_bicgstab_loop`` and ``_cg_loop``, which fetch a flag at each
convergence test.  ``lobpcg`` runs ``_lobpcg.lobpcg_standard`` (the
port's copy of jax's), applying the operator to whole blocks.

Results are tensors on the operator's device (the JAX package returns
numpy arrays); ``ArpackNoConvergence`` carries numpy arrays, as
scipy's does.  The JAX package's host escapes stay, with their
conditions and no others: ``which='SM'`` or a shift whose inexact
inverse stagnates, preconditioned or constrained ``lobpcg``, complex
``lobpcg`` past 2^15 rows, ``lobpcg`` with 5k >= n, and ``lobpcg(B=)``
past 2^15 rows.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import linalg as _linalg
from .types import to_numpy_dtype, to_torch_dtype
from .utils import as_tensor, to_numpy

__all__ = ["eigs", "eigsh", "lobpcg", "svds"]


def _operator_parts(A):
    """(matvec, n_rows, n_cols, dtype, device) for a sparse array, dense
    array, LinearOperator, or scipy sparse operand."""
    from .runtime import resolve_device

    op = _linalg.make_linear_operator(A)
    m, n = op.shape
    dev = getattr(op, "device", None)
    if dev is None:
        dev = resolve_device(None)
    dtype = op.dtype
    if dtype is None:
        dtype = op.matvec(torch.zeros(n, dtype=torch.float64,
                                      device=dev)).dtype
    return op.matvec, int(m), int(n), dtype, dev


def _host_fallback(name):
    import scipy.sparse.linalg as _ssl

    from .coverage import scipy_fallback

    return scipy_fallback(getattr(_ssl, name), f"linalg.{name}")


def _fetch(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host in its own dtype, through the one helper that
    makes (and counts) the solvers' fetches."""
    return np.asarray(_linalg._host_fetch(t),
                      dtype=to_numpy_dtype(t.dtype)).reshape(tuple(t.shape))


def _block(matvec):
    """``X -> [matvec(X[:, j])]_j``: one ``matmat`` (an SpMM) when
    ``matvec`` is an operator's own, else a matvec a column."""
    op = getattr(matvec, "__self__", None)
    if isinstance(op, _linalg.LinearOperator):
        return op.matmat
    return lambda X: torch.stack(
        [matvec(X[:, j]) for j in range(X.shape[1])], dim=1)


def _basis_times(V: torch.Tensor, y: np.ndarray, dtype) -> torch.Tensor:
    """``V^T y`` for the (m, n) basis and a host (m, k) ``y`` in
    ``dtype``; a real basis meets complex ``y`` in two real products."""
    yt = torch.as_tensor(np.ascontiguousarray(y), device=V.device).to(dtype)
    if yt.is_complex() and not V.is_complex():
        Vt = V.T
        return torch.complex(Vt @ yt.real.to(V.dtype),
                             Vt @ yt.imag.to(V.dtype))
    return V.T @ yt.to(V.dtype)


def _on(t, dev):
    return torch.as_tensor(np.ascontiguousarray(t), device=dev)


def _complex_matvec(matvec, dtype, cdtype):
    """Complex basis over a real operator: two real matvecs per apply
    (``eigs``'s complex start, the complex-shift shift-invert path)."""

    def mv(x):
        return (matvec(x.real.to(dtype)).to(cdtype)
                + 1j * matvec(x.imag.to(dtype)).to(cdtype))

    return mv


def _generator(dev, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _restart_direction(V, key: int, j: int, rdtype, dtype, mask=None):
    """A fresh random direction orthogonal to the rows of ``V``: the
    breakdown restart of the Lanczos and Arnoldi recurrences (an
    invariant subspace was found; the zero vector would fabricate
    spectrum).  Drawn from a generator seeded from ``key`` and ``j`` on
    ``V``'s device."""
    eps = torch.finfo(rdtype).eps
    fresh = torch.randn(V.shape[1], generator=_generator(
        V.device, (key << 32) + j), dtype=rdtype, device=V.device).to(dtype)
    if mask is not None:
        fresh = fresh * mask
    for _ in range(2):
        fresh = fresh - V.T @ _linalg._global_sum(V.conj() @ fresh)
    return fresh / torch.clamp_min(_linalg._norm(fresh), eps)


def _first_restart(flags: np.ndarray, start: int, m: int):
    """The first step at or after ``start`` that broke down and is not
    the last (whose restart direction nothing reads), else None."""
    hits = np.flatnonzero(flags[start:m - 1])
    return start + int(hits[0]) if hits.size else None


def _outer_atol(tol, rdtype):
    """Default convergence tolerance (the escalation drivers and the
    shift-invert inner-solve sizing)."""
    return float(tol) if tol else float(torch.finfo(rdtype).eps ** 0.5)


def _validate_be_k(which, k):
    """scipy/ARPACK parity: NEV=1 with BE is info=-13."""
    if which == "BE" and k < 2:
        from scipy.sparse.linalg import ArpackError

        raise ArpackError(
            -13, {-13: "NEV and WHICH = 'BE' are incompatible."})


def _require_real_sigma(sigma):
    """scipy parity: float(sigma) raises on any complex, even with a
    zero imaginary part."""
    if np.iscomplexobj(sigma):
        raise TypeError(
            "eigsh sigma must be a real number, not complex")


def _escalation_params(tol, rdtype, ncv, k, rank, maxiter,
                       min_extra: int = 1):
    """(atol, first subspace size m, retry count) of the escalation
    drivers."""
    atol = _outer_atol(tol, rdtype)
    m = int(ncv) if ncv is not None else min(rank, max(2 * k + 1, 20))
    m = min(max(m, k + min_extra), rank)
    tries = max(int(maxiter) if maxiter is not None else 6, 1)
    return atol, m, tries


def _require_converged(resid, atol, scale, m, cap, w_k, X=None):
    """scipy parity on escalation exhaustion: raise
    ``ArpackNoConvergence`` carrying the converged subset.  ``m >= cap``
    means the Krylov space is the whole space: never an error."""
    ok = resid <= atol * scale
    if bool(np.all(ok)) or m >= cap:
        return
    from scipy.sparse.linalg import ArpackNoConvergence

    w_k = to_numpy(w_k) if isinstance(w_k, torch.Tensor) else w_k
    raise ArpackNoConvergence(
        f"ARPACK-style error: no convergence "
        f"({int(ok.sum())}/{ok.size} eigenvalues converged; "
        f"subspace m={m}, cap={cap})",
        np.asarray(w_k)[ok],
        (to_numpy(X)[:, ok] if X is not None
         else np.empty((0, int(ok.sum())))),
    )


# ----------------------------------------------------- shift-invert inner


def _inner_solver_params(outer_atol: float, rdtype, n: int):
    """(absolute atol for a unit-norm rhs, iteration cap) of every
    inexact inner solve."""
    eps = float(torch.finfo(rdtype).eps)
    return (max(1e-2 * float(outer_atol), 50.0 * eps),
            int(min(10 * n + 20, 100_000)))


def _shift_invert_op(matvec, sigma, dtype, dev, n, outer_atol, sym: bool):
    """``v -> (A - sigma I)^{-1} v`` by an inexact inner Krylov solve:
    MINRES for symmetric/Hermitian operators (A - sigma I is indefinite
    for an interior sigma), BiCGSTAB for general ones.  The outer
    recurrences feed unit-norm operands, so a fixed absolute inner
    tolerance two digits under the outer one bounds the apply's
    backward error below the outer test's resolution."""
    from .krylov_extra import _minres_loop

    inner_atol, inner_maxiter = _inner_solver_params(
        outer_atol, dtype.to_real(), n)
    shift = torch.tensor(sigma, dtype=dtype, device=dev)
    ident = lambda r: r  # noqa: E731

    if sym:
        def solve(v):
            v = v.to(dtype)
            return _minres_loop(matvec, ident, v, torch.zeros_like(v),
                                shift, inner_atol, inner_maxiter, 10)[0]
    else:
        def shifted(x):
            return matvec(x) - shift * x

        def solve(v):
            v = v.to(dtype)
            return _linalg._bicgstab_loop(shifted, ident, v,
                                          torch.zeros_like(v), inner_atol,
                                          inner_maxiter, 10)[0]

    return solve, inner_atol


def _probe_inverse(matvec, solve, sigma, dtype, dev, n, inner_atol, name,
                   mask=None):
    """One explicit (A - sigma I)x = v solve with a true residual check
    before any recurrence runs.  On a singular (A - sigma I) the
    iterative solve converges to a pseudo-inverse apply whose Ritz pairs
    pass every residual test while missing the null-space eigenvalue
    nearest sigma; the stagnated probe residual is the signature, and
    ``ArpackNoConvergence`` sends the caller to its host fallback.
    ``mask`` (a padded operator's valid rows) keeps the probe off the
    padding and gives its length."""
    shift = torch.tensor(sigma, dtype=dtype, device=dev)
    _probe_apply(lambda x: matvec(x) - shift * x, solve,
                 n if mask is None else mask.shape[0], dtype, dev,
                 inner_atol, f"shift-invert {name}", mask=mask)


def _check_original_residuals(matvec, lam, X, atol, name):
    """Judge the returned pairs in the original operator's metric (one
    block apply): a stagnated inner solve corrupts the operator silently
    and the outer recurrence converges on the corrupted one, so this is
    the acceptance test.  Raises ``ArpackNoConvergence`` with the
    passing subset."""
    AX = to_numpy(_block(matvec)(X))
    Xh = to_numpy(X)
    D = AX - Xh * lam[None, :]
    # Column norms, summed over the ranks of a distributed operator.
    resid = np.sqrt(to_numpy(_linalg._global_sum(torch.as_tensor(
        (D.conj() * D).real.sum(axis=0), device=X.device))))
    scale = np.maximum(np.abs(lam), 1.0)
    # Slack x50: the inner solve is inexact by design (inner_atol is
    # 1e-2 * atol); this rejects stagnation, not last-digit noise.
    ok = resid <= 50.0 * atol * scale
    if bool(np.all(ok)):
        return
    from scipy.sparse.linalg import ArpackNoConvergence

    raise ArpackNoConvergence(
        f"shift-invert {name}: inexact inner solve did not reach the "
        f"requested accuracy ({int(ok.sum())}/{ok.size} pairs pass the "
        f"original-spectrum residual test; sigma may be too close to "
        f"an eigenvalue for the iterative inner solver — widen sigma "
        f"or loosen tol)",
        np.asarray(lam)[ok], Xh[:, ok],
    )


# ---------------------------------------------------------------- Lanczos


def _lanczos_general(matvec_a, matvec_m, solve_m, v0, m: int,
                     si: bool = False, rhs_fn=None):
    """m-step B-inner-product Lanczos for the generalized symmetric
    problem (ARPACK modes 2-5), B = ``matvec_m``.  ``si=False`` (mode
    2): the operator is ``M^{-1} A``, ``solve_m`` solves with M.
    ``si=True``: the operator is ``(A - sigma M)^{-1} rhs(v)``, with
    ``rhs_fn`` the inner-product matvec by default (modes 3/4) or
    ``(A + sigma M) v`` (cayley).  Returns (V, alphas, betas) on the
    device, V's rows B-orthonormal."""
    n = v0.shape[0]
    dtype = v0.dtype
    rdtype = dtype.to_real()
    eps = torch.finfo(rdtype).eps
    dev = v0.device
    gen = _generator(dev, 23)

    def m_reorth(V, w):
        # w -= V^T <V, w>_M, applied twice (classical GS, Parlett).
        for _ in range(2):
            q = matvec_m(w)
            w = w - V.T @ (V.conj() @ q)
        return w

    def m_normalize(w):
        nrm = torch.sqrt(torch.clamp_min(
            _linalg._vdot(w, matvec_m(w)).real, 0)).to(rdtype)
        return w / torch.where(nrm == 0, 1.0, nrm).to(dtype), nrm

    V = torch.zeros((m, n), dtype=dtype, device=dev)
    alphas = torch.zeros((m,), dtype=dtype, device=dev)
    betas = torch.zeros((m,), dtype=dtype, device=dev)
    v, beta, v_prev = v0, torch.zeros((), dtype=dtype, device=dev), \
        torch.zeros_like(v0)
    for j in range(m):
        if si:
            mv = matvec_m(v)
            rhs = mv if rhs_fn is None else rhs_fn(v)
            w = solve_m(rhs)                  # (A - sigma M)^{-1} rhs
            # <v, OP v>_B = (B v)^H w (B Hermitian).
            alpha = _linalg._vdot(mv, w).real.to(dtype)
        else:
            av = matvec_a(v)
            w = solve_m(av)                   # M^{-1} A v
            alpha = _linalg._vdot(v, av).real.to(dtype)
        w = w - alpha * v - beta * v_prev
        V[j] = v
        Vj = V[:j + 1]
        w = m_reorth(Vj, w)
        w, beta_next = m_normalize(w)
        broke = beta_next <= 100 * eps * torch.clamp_min(alpha.real.abs(),
                                                         1.0)
        fresh = torch.randn(n, generator=gen, dtype=rdtype,
                            device=dev).to(dtype)
        fresh, _ = m_normalize(m_reorth(Vj, fresh))
        beta_out = torch.where(broke, torch.zeros((), dtype=rdtype,
                                                  device=dev), beta_next)
        alphas[j] = alpha
        betas[j] = beta_out.to(dtype)
        v_prev, v = v, torch.where(broke, fresh, w)
        beta = beta_out.to(dtype)
    return V, alphas, betas


def _select_sym_ritz(w, y, k: int, which: str):
    """LA/SA/LM/SM/BE Ritz selection of the symmetric drivers, ascending
    (scipy).  Under shift-invert ``w`` is the transformed spectrum, so SM
    there means smallest |nu| = farthest from sigma (ARPACK)."""
    if which == "LA":
        sel = np.argsort(w)[-k:]
    elif which == "SA":
        sel = np.argsort(w)[:k]
    elif which == "SM":
        sel = np.argsort(np.abs(w))[:k]
    elif which == "BE":
        # scipy: k/2 from each end, the extra one from the high end.
        lo = k // 2
        order = np.argsort(w)
        sel = np.concatenate([order[:lo], order[lo - k:]])
    else:  # LM
        sel = np.argsort(np.abs(w))[-k:]
    sel = sel[np.argsort(w[sel])]
    return w[sel], y[:, sel]


def _normalized_rhs_solver(solve_unit):
    """Wrap a unit-rhs inner solver so its absolute tolerance applies
    relative to each right-hand side's norm (the generalized apply's
    rhs is A v or M v, not a unit vector)."""

    def solve(b):
        nrm = torch.linalg.vector_norm(b)
        safe = torch.where(nrm == 0, 1.0, nrm).to(b.dtype)
        return solve_unit(b / safe) * safe

    return solve


def _probe_apply(apply_fn, solve, n, dtype, dev, inner_atol, what,
                 mask=None):
    """One explicit solve of ``apply_fn(x) = v`` with a true residual
    check before any recurrence runs (see ``_probe_inverse``).  Returns
    the probe RNG so callers draw consistent start vectors."""
    rng = np.random.default_rng(20260801)
    v = _on(rng.standard_normal(n), dev).to(dtype)
    if mask is not None:
        v = v * mask
    v = v / _linalg._norm(v)
    x = solve(v)
    res = float(_linalg._norm(apply_fn(x) - v))
    if not np.isfinite(res) or res > 100.0 * inner_atol:
        from scipy.sparse.linalg import ArpackNoConvergence

        raise ArpackNoConvergence(
            f"{what}: inner solve stagnated at residual {res:.2e} "
            f"(target {inner_atol:.2e}) — operator singular or too "
            f"ill-conditioned for the iterative inner solver",
            np.empty(0), np.empty((n, 0)))
    return rng


def _m_normalized_start(v0, matvec_m, dtype, dev, n, rng):
    """Start vector for the M-inner recurrences, M-normalized."""
    if v0 is None:
        v0 = rng.standard_normal(n)
    v0 = as_tensor(v0, dev).to(dtype)
    mnrm = float(np.sqrt(max(
        float(_linalg._vdot(v0, matvec_m(v0)).real), 1e-300)))
    return v0 / torch.tensor(mnrm, dtype=dtype, device=dev)


def _general_lanczos_drive(matvec_a, matvec_m, solve, si, v0, k, which,
                           ncv, maxiter, tol, rank, rdtype, dtype,
                           rhs_fn=None):
    """Escalation loop of the generalized modes 2-5: ``(w_k, X, resid,
    atol, scale, m)``, ``w_k`` in the operator's own spectrum (pencil
    eigenvalues for mode 2, the mode's transformed nu otherwise)."""
    import scipy.linalg as _sl

    atol, m, tries = _escalation_params(tol, rdtype, ncv, k, rank,
                                        maxiter)
    for try_i in range(tries):
        if try_i:
            m = min(rank, 2 * m)
        V, alphas, betas = _lanczos_general(matvec_a, matvec_m, solve, v0,
                                            m=m, si=si, rhs_fn=rhs_fn)
        ab = _fetch(torch.stack([alphas.real, betas.real]).to(
            torch.float64))
        a, b_all = ab[0], ab[1]
        w, y = _sl.eigh_tridiagonal(a, b_all[:-1])
        w_k, y_k = _select_sym_ritz(w, y, k, which)
        resid = np.abs(b_all[-1]) * np.abs(y_k[-1, :])
        # A spectrum-magnitude floor (not the standard driver's 1.0): a
        # pencil scaled by 1e-6 gets 1e-6-scaled acceptance.
        floor = max(float(np.max(np.abs(w))),
                    float(torch.finfo(rdtype).tiny))
        scale = np.maximum(np.abs(w_k), floor)
        if np.all(resid <= atol * scale) or m >= rank:
            break
    X = _basis_times(V, y_k, dtype)
    return w_k, X, resid, atol, scale, m


def _eigsh_generalized(matvec_a, matvec_m, n, dtype, dev, k, which, v0,
                       ncv, maxiter, tol, return_eigenvectors,
                       max_rank=None):
    """Generalized ``eigsh(A, M=M)`` (ARPACK mode 2): M-inner Lanczos on
    ``M^{-1} A`` with an inexact inner CG.  ``max_rank`` bounds the
    escalated basis (the lobpcg-B route's O(max(8k, 128)) cap)."""
    rdtype = dtype.to_real()
    atol_outer = _outer_atol(tol, rdtype)
    inner_atol, inner_maxiter = _inner_solver_params(atol_outer, rdtype,
                                                     n)
    ident = lambda r: r  # noqa: E731
    solve_m = _normalized_rhs_solver(
        lambda b: _linalg._cg_loop(matvec_m, ident, b, torch.zeros_like(b),
                                   inner_atol, inner_maxiter, 10)[0])
    # M must be solvable to the inner tolerance (SPD, nonsingular).
    rng = _probe_apply(matvec_m, solve_m, n, dtype, dev, inner_atol,
                       "generalized eigsh")
    v0 = _m_normalized_start(v0, matvec_m, dtype, dev, n, rng)
    rank = int(max_rank) if max_rank is not None else n
    w_k, X, resid, atol, scale, m = _general_lanczos_drive(
        matvec_a, matvec_m, solve_m, False, v0, k, which, ncv, maxiter,
        tol, rank, rdtype, dtype)
    w_k = w_k.astype(to_numpy_dtype(rdtype))
    _pencil_residual_guard(matvec_a, matvec_m, w_k, X, atol_outer,
                           rdtype)
    _require_converged(resid, atol, scale, m, rank, w_k, X)
    if not return_eigenvectors:
        return _on(w_k, dev)
    return _on(w_k, dev), X


def _pencil_residual_guard(matvec_a, matvec_m, w_k, X, atol_outer,
                           rdtype):
    """Original-pencil residual guard (modes 2 and 3): ``||A x - lambda
    M x||`` relative to the pencil's own magnitude per pair."""
    AX = to_numpy(_block(matvec_a)(X))
    MX = to_numpy(_block(matvec_m)(X))
    res_p = np.linalg.norm(AX - MX * w_k[None, :], axis=0)
    denom = np.maximum.reduce([
        np.linalg.norm(AX, axis=0),
        np.abs(w_k) * np.linalg.norm(MX, axis=0),
        np.full(res_p.shape, float(torch.finfo(rdtype).tiny)),
    ])
    ok = res_p / denom <= 50.0 * atol_outer
    if not bool(np.all(ok)):
        from scipy.sparse.linalg import ArpackNoConvergence

        raise ArpackNoConvergence(
            f"generalized eigsh: {int(ok.sum())}/{ok.size} pairs pass "
            f"the pencil residual test", w_k[ok], to_numpy(X)[:, ok])


def _eigsh_generalized_si(matvec_a, matvec_m, sigma: float, n, dtype, dev,
                          k, which, v0, ncv, maxiter, tol,
                          return_eigenvectors, mode: str = "normal"):
    """Generalized shift-invert (ARPACK modes 3/4/5): B-inner Lanczos on
    the mode's operator with an inexact MINRES inner solve of the
    shifted pencil ``A - sigma M``.  ``which`` applies to the
    transformed ``nu``; results transform back and return ascending.

    ========  =========================  ==========  ====================
    mode      operator                   B (inner)   back-transform
    ========  =========================  ==========  ====================
    normal    (A - sM)^{-1} M            M           s + 1/nu
    buckling  (A - sM)^{-1} A            A           s*nu / (nu - 1)
    cayley    (A - sM)^{-1} (A + sM)     M           s*(nu+1) / (nu-1)
    ========  =========================  ==========  ====================
    """
    from .krylov_extra import _minres_loop

    rdtype = dtype.to_real()
    np_r = to_numpy_dtype(rdtype)
    atol_outer = _outer_atol(tol, rdtype)
    inner_atol, inner_maxiter = _inner_solver_params(atol_outer, rdtype,
                                                     n)
    ident = lambda r: r  # noqa: E731
    sig = torch.tensor(sigma, dtype=dtype, device=dev)

    def shifted(x):
        return matvec_a(x) - sig * matvec_m(x)

    solve_si = _normalized_rhs_solver(
        lambda b: _minres_loop(shifted, ident, b, torch.zeros_like(b),
                               torch.zeros((), dtype=b.dtype,
                                           device=b.device),
                               inner_atol, inner_maxiter, 10)[0])
    # sigma on an eigenvalue of the pencil, or hopeless conditioning:
    # fall back, never corrupt silently.
    rng = _probe_apply(shifted, solve_si, n, dtype, dev, inner_atol,
                       "generalized shift-invert")
    tiny = float(torch.finfo(rdtype).tiny)
    if mode == "buckling":
        inner_mv = matvec_a           # B = A (A must be positive)
        rhs_fn = None

        def back(nu):
            d = np.where(np.abs(nu - 1.0) < tiny, tiny, nu - 1.0)
            return (float(sigma) * nu / d).astype(np_r)
    elif mode == "cayley":
        inner_mv = matvec_m

        def rhs_fn(v):
            return matvec_a(v) + sig * matvec_m(v)

        def back(nu):
            d = np.where(np.abs(nu - 1.0) < tiny, tiny, nu - 1.0)
            return (float(sigma) * (nu + 1.0) / d).astype(np_r)
    else:
        inner_mv = matvec_m
        rhs_fn = None

        def back(nu):
            nz = np.where(nu == 0, tiny, nu)
            return (float(sigma) + 1.0 / nz).astype(np_r)

    v0 = _m_normalized_start(v0, inner_mv, dtype, dev, n, rng)
    w_nu, X, resid, atol, scale, m = _general_lanczos_drive(
        matvec_a, inner_mv, solve_si, True, v0, k, which, ncv, maxiter,
        tol, n, rdtype, dtype, rhs_fn=rhs_fn)
    lam = back(w_nu)
    # Before reordering, while resid/scale align with lam's columns.
    _require_converged(resid, atol, scale, m, n, lam, X)
    order = np.argsort(lam)
    lam, X = lam[order], X[:, _on(order, dev)]
    _pencil_residual_guard(matvec_a, matvec_m, lam, X, atol_outer,
                           rdtype)
    if not return_eigenvectors:
        return _on(lam, dev)
    return _on(lam, dev), X


def _lanczos(matvec, v0, mask, m: int):
    """m-step Lanczos with full reorthogonalisation, applied twice.

    Returns (V, alphas, betas): V (m, n) on the device with orthonormal
    rows, and on the host (float64) the real parts of T =
    tridiag(betas[1:], alphas, betas[1:]).  A run of steps makes no host
    synchronisation; its one fetch brings alphas, betas and the
    breakdown flags.  A breakdown (an invariant subspace) continues from
    a fresh direction orthogonal to V (``_restart_direction``), so T
    decouples at the zero off-diagonal instead of gaining fabricated
    zero eigenvalues: the steps after the first breakdown are run again
    from it, one more fetch each.  The JAX package's scan draws a fresh
    direction at every step and selects it with ``where``; drawing it
    only where a step broke down gives the same recurrence and spares a
    second vector's reorthogonalisation on every step.  ``mask`` keeps a
    restart inside the valid subspace of a padded operator."""
    n = v0.shape[0]
    dtype = v0.dtype
    rdtype = dtype.to_real()
    eps = torch.finfo(rdtype).eps
    dev = v0.device
    # Rows past j are never read before step j sets them.
    V = torch.empty((m, n), dtype=dtype, device=dev)
    alphas = torch.zeros((m,), dtype=dtype, device=dev)
    betas = torch.zeros((m,), dtype=dtype, device=dev)
    broke = torch.zeros((m,), dtype=torch.bool, device=dev)
    v, v_prev = v0, torch.zeros_like(v0)
    beta = torch.zeros((), dtype=dtype, device=dev)
    start = 0
    while True:
        for j in range(start, m):
            w = matvec(v).to(dtype)
            alpha = _linalg._vdot(v, w).real.to(dtype)
            w = w - alpha * v - beta * v_prev
            V[j] = v
            Vj = V[:j + 1]
            # Classical Gram-Schmidt against the rows set so far, twice
            # (twice is enough, Parlett).
            for _ in range(2):
                w = w - Vj.T @ _linalg._global_sum(Vj.conj() @ w)
            beta_next = _linalg._norm(w).to(dtype)
            flag = beta_next.real <= 100 * eps * torch.clamp_min(
                alpha.real.abs(), 1.0)
            beta_next = torch.where(flag, torch.zeros_like(beta_next),
                                    beta_next)
            v_prev, v = v, w / torch.where(beta_next == 0, 1.0, beta_next)
            beta = beta_next
            alphas[j] = alpha
            betas[j] = beta_next
            broke[j] = flag
        host = _fetch(torch.stack([alphas.real.to(torch.float64),
                                   betas.real.to(torch.float64),
                                   broke.to(torch.float64)]))
        j0 = _first_restart(host[2], start, m)
        if j0 is None:
            return V, host[0], host[1]
        v = _restart_direction(V[:j0 + 1], 7, j0, rdtype, dtype, mask)
        v_prev = V[j0]
        beta = torch.zeros((), dtype=dtype, device=dev)
        start = j0 + 1


def _lanczos_eigsh(matvec, n, dtype, dev, k, which, v0, ncv, maxiter, tol,
                   return_eigenvectors, max_rank=None, mask=None):
    """The Lanczos escalation of ``eigsh``; ``max_rank`` caps the Krylov
    dimension and ``mask`` keeps breakdown restarts on the valid rows of
    a padded operator (``parallel.dist_eigsh``)."""
    import scipy.linalg as _sl

    rdtype = dtype.to_real()
    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(n)
    v0 = as_tensor(v0, dev).to(dtype)
    v0 = v0 / _linalg._norm(v0)
    rank = int(max_rank) if max_rank is not None else n
    # Escalate the subspace until the Ritz residuals converge (each
    # retry doubles m; n caps it).  tol=0 means machine precision.
    atol, m, tries = _escalation_params(tol, rdtype, ncv, k, rank,
                                        maxiter)
    for try_i in range(tries):
        if try_i:
            m = min(rank, 2 * m)
        # m doubles only right before a run: the checks after the loop
        # judge the size that ran.
        V, a, b_all = _lanczos(matvec, v0, mask, m=m)
        w, y = _sl.eigh_tridiagonal(a, b_all[:-1])
        w_k, y_k = _select_sym_ritz(w, y, k, which)
        # Ritz residual bound |beta_{m+1} e_m^T y_i|: the final
        # recurrence beta, not T's last off-diagonal.
        resid = np.abs(b_all[-1]) * np.abs(y_k[-1, :])
        scale = np.maximum(np.abs(w_k), 1.0)
        if np.all(resid <= atol * scale) or m >= rank:
            break
    w_k = w_k.astype(to_numpy_dtype(rdtype))
    converged = bool(np.all(resid <= atol * scale)) or m >= rank
    if converged and not return_eigenvectors:
        return _on(w_k, dev)
    X = _basis_times(V, y_k, dtype)
    _require_converged(resid, atol, scale, m, rank, w_k, X)
    if not return_eigenvectors:
        return _on(w_k, dev)
    return _on(w_k, dev), X


def eigsh(A, k=6, M=None, sigma=None, which="LM", v0=None, ncv=None,
          maxiter=None, tol=0, return_eigenvectors=True, **kwargs):
    """k eigenpairs of a symmetric/Hermitian operator (scipy ``eigsh``).

    The standard problem with ``which`` in {LM, LA, SA, BE} runs the
    Lanczos above on the operator's device.  Shift-invert ``sigma``
    (mode 'normal') runs Lanczos on ``(A - sigma I)^{-1}`` with an
    inexact MINRES inner apply, where scipy/ARPACK factorizes with
    ``splu``; ``which`` then refers to ``nu = 1/(lambda - sigma)`` and
    results transform back.  ``which='SM'`` without sigma is
    shift-invert at 0, with host ARPACK as the fallback when the inexact
    inverse stagnates (a singular A).  Generalized pencils (SPD M): the
    M-inner Lanczos with an inner CG without sigma
    (``_eigsh_generalized``), the shift-invert family
    ``mode='normal'/'buckling'/'cayley'`` with it
    (``_eigsh_generalized_si``), host fallback when an inner-solve probe
    stagnates.  Other calls go to scipy on the host."""
    mode = kwargs.pop("mode", "normal")
    native_which = ("LM", "LA", "SA", "BE", "SM")
    si_modes = ("normal", "buckling", "cayley")
    sm_native = which == "SM" and sigma is None and M is None and not kwargs
    gen_native = (M is not None and sigma is None and mode == "normal"
                  and which in native_which and not kwargs)
    gen_si_native = (sigma is not None and mode in si_modes
                     and which in native_which and not kwargs
                     and (M is not None or mode != "normal"))
    if not sm_native and not gen_native and not gen_si_native and (
            M is not None or which not in native_which or kwargs
            or (sigma is not None and mode != "normal")):
        return _host_fallback("eigsh")(
            A, k=k, M=M, sigma=sigma, which=which, v0=v0, ncv=ncv,
            maxiter=maxiter, tol=tol, mode=mode,
            return_eigenvectors=return_eigenvectors, **kwargs)
    matvec, m_rows, n_cols, dtype, dev = _operator_parts(A)
    if m_rows != n_cols:
        raise ValueError("expected square matrix")
    if not (0 < k < n_cols):
        raise ValueError(f"k={k} must satisfy 0 < k < n={n_cols}")
    _validate_be_k(which, k)
    if gen_native or gen_si_native:
        from scipy.sparse.linalg import ArpackNoConvergence

        if gen_si_native:
            _require_real_sigma(sigma)
            if mode != "normal" and float(sigma) == 0.0:
                raise ValueError(
                    f"mode={mode!r} requires a nonzero sigma "
                    f"(the transform degenerates at 0)")
        if M is not None:
            mv_m, mr, mc, mdtype, _ = _operator_parts(M)
            if (mr, mc) != (n_cols, n_cols):
                raise ValueError(
                    f"M has shape {(mr, mc)}, "
                    f"expected {(n_cols, n_cols)}")
            pdtype = torch.promote_types(dtype, mdtype)
        else:
            mv_m = lambda x: x  # noqa: E731
            pdtype = dtype
        # The host fallback below sees the caller's sigma/which, not the
        # SM remap's sigma=0 (scipy's splu(A - 0*M) raises on exactly
        # the singular A the fallback serves).
        use_si, sig, wch = gen_si_native, sigma, which
        if not gen_si_native and which == "SM":
            # Smallest magnitude of a pencil as shift-invert at 0.
            use_si, sig, wch = True, 0.0, "LM"
        try:
            if use_si:
                return _eigsh_generalized_si(
                    matvec, mv_m, float(sig), n_cols, pdtype, dev, int(k),
                    wch, v0, ncv, maxiter, tol, return_eigenvectors,
                    mode=mode)
            return _eigsh_generalized(
                matvec, mv_m, n_cols, pdtype, dev, int(k), wch, v0, ncv,
                maxiter, tol, return_eigenvectors)
        except ArpackNoConvergence:
            return _host_fallback("eigsh")(
                A, k=k, M=M, sigma=sigma, which=which, v0=v0, ncv=ncv,
                maxiter=maxiter, tol=tol, mode=mode,
                return_eigenvectors=return_eigenvectors)
    if sm_native:
        # Smallest magnitude = largest of A^{-1}: shift-invert at 0.
        from scipy.sparse.linalg import ArpackNoConvergence

        try:
            return _eigsh_shift_invert(
                matvec, n_cols, dtype, dev, int(k), 0.0, "LM", v0, ncv,
                maxiter, tol, return_eigenvectors)
        except ArpackNoConvergence:
            # A stagnated inexact inverse (singular A): host ARPACK's
            # direct-SM Lanczos.
            return _host_fallback("eigsh")(
                A, k=k, which="SM", v0=v0, ncv=ncv, maxiter=maxiter,
                tol=tol, return_eigenvectors=return_eigenvectors)
    if sigma is None:
        return _lanczos_eigsh(matvec, n_cols, dtype, dev, int(k), which,
                              v0, ncv, maxiter, tol, return_eigenvectors)

    # Shift-invert: Lanczos on (A - sigma I)^{-1}; a sigma near an
    # eigenvalue stagnates the inexact MINRES where scipy's splu
    # succeeds, so those go to host ARPACK.
    _require_real_sigma(sigma)
    from scipy.sparse.linalg import ArpackNoConvergence

    try:
        return _eigsh_shift_invert(matvec, n_cols, dtype, dev, int(k),
                                   float(sigma), which, v0, ncv, maxiter,
                                   tol, return_eigenvectors)
    except ArpackNoConvergence:
        return _host_fallback("eigsh")(
            A, k=k, sigma=sigma, which=which, v0=v0, ncv=ncv,
            maxiter=maxiter, tol=tol,
            return_eigenvectors=return_eigenvectors)


def _eigsh_shift_invert(matvec, n_cols, dtype, dev, k, sigma, which, v0,
                        ncv, maxiter, tol, return_eigenvectors,
                        name="eigsh", mask=None, max_rank=None):
    """Shift-invert eigsh (see ``eigsh``): Lanczos on ``OP = (A - sigma
    I)^{-1}`` with the inexact MINRES inner apply.  ``mask`` and
    ``max_rank`` serve ``parallel.dist_eigsh``: the probe and the Krylov
    space stay on the valid rows, the Krylov dimension at most the true
    row count."""
    rdtype = dtype.to_real()
    np_r = to_numpy_dtype(rdtype)
    atol_outer = _outer_atol(tol, rdtype)
    op, inner_atol = _shift_invert_op(matvec, float(sigma), dtype, dev,
                                      n_cols, atol_outer, sym=True)
    _probe_inverse(matvec, op, float(sigma), dtype, dev, n_cols,
                   inner_atol, name, mask=mask)

    # X is always formed: the original-spectrum check below is what
    # catches a stagnated inner solve.
    def back_l(nu):
        nz = np.where(nu == 0, float(torch.finfo(rdtype).tiny), nu)
        return (float(sigma) + 1.0 / nz).astype(np_r)

    from scipy.sparse.linalg import ArpackNoConvergence

    try:
        w_nu, X = _lanczos_eigsh(op, n_cols, dtype, dev, int(k), which,
                                 v0, ncv, maxiter, tol, True,
                                 max_rank=max_rank, mask=mask)
    except ArpackNoConvergence as e:
        # Re-raise with back-transformed eigenvalues, so a caller
        # salvaging e.eigenvalues gets eigenvalues of A.
        raise ArpackNoConvergence(
            str(e), back_l(np.asarray(e.eigenvalues)), e.eigenvectors,
        ) from None
    # nu = 1/(lambda - sigma): the eigenvectors are A's.
    lam = back_l(to_numpy(w_nu))
    order = np.argsort(lam)                 # scipy returns ascending
    lam, X = lam[order], X[:, _on(order, dev)]
    _check_original_residuals(matvec, lam, X, atol_outer, name)
    if not return_eigenvectors:
        return _on(lam, dev)
    return _on(lam, dev), X


# ---------------------------------------------------------------- LOBPCG


def _block_seed(X, dtype):
    """One Lanczos start vector carrying the whole guess block: a fixed
    random combination (seed 11) of the orthonormalized columns of X,
    which overlaps every direction the block spans."""
    Xa = to_numpy(X) if isinstance(X, torch.Tensor) else np.asarray(X)
    q, _ = np.linalg.qr(Xa.astype(np.promote_types(
        Xa.dtype, to_numpy_dtype(dtype))))
    w = np.random.default_rng(11).standard_normal(q.shape[1])
    return q @ w.astype(q.dtype)


def lobpcg(A, X, B=None, M=None, Y=None, tol=None, maxiter=20,
           largest=True, **kwargs):
    """Locally optimal block PCG eigensolver (scipy ``lobpcg``).

    The standard real problem (no B/M/Y) runs ``_lobpcg.lobpcg_standard``
    on the operator's device, one block SpMM a product; the smallest
    eigenvalues come from the negated operator, and ``maxiter`` is the
    block-iteration count.  A generalized ``B`` (SPD, up to 2^15 rows)
    and a complex Hermitian operator (up to 2^15 rows) run the
    single-vector Lanczos drivers from one start vector that combines
    the columns of ``X`` (``_block_seed``), with the basis capped at
    ``max(8k, 128)`` and ``maxiter`` (clamped to [1, 10]) counting the
    escalation retries instead of block iterations.  Preconditioned or
    constrained forms, 5k >= n, and the cases past those row limits go
    to scipy on the host.  scipy's ``lobpcg`` never raises on
    non-convergence; the complex route returns its best subspace with a
    warning."""
    Xshape = tuple(X.shape) if hasattr(X, "shape") else np.shape(X)
    if (B is not None and M is None and Y is None and not kwargs
            and Xshape[0] <= (1 << 15)):
        from scipy.sparse.linalg import ArpackNoConvergence

        mv_a, ar, ac, adt, dev = _operator_parts(A)
        mv_b, br, bc, bdt, _ = _operator_parts(B)
        if ar != ac or (br, bc) != (ar, ac):
            raise ValueError("A and B must be square and conformal")
        if len(Xshape) != 2 or Xshape[0] != ac:
            raise ValueError(f"X must be (n, k) with n={ac}")
        kb = Xshape[1]
        cap_b = min(ac, max(8 * kb, 128))
        tries_b = max(1, min(int(maxiter) if maxiter is not None
                             else 6, 10))
        xdt = (X.dtype if isinstance(X, torch.Tensor)
               else to_torch_dtype(np.asarray(X).dtype))
        pdt_b = torch.promote_types(torch.promote_types(adt, bdt), xdt)
        try:
            w, V = _eigsh_generalized(
                mv_a, mv_b, ac, pdt_b, dev, kb, "LA" if largest else "SA",
                _block_seed(X, pdt_b), None, tries_b, (tol if tol else 0),
                True, max_rank=cap_b)
            order = torch.argsort(w, descending=largest)
            return w[order], V[:, order]
        except ArpackNoConvergence:
            return _host_fallback("lobpcg")(
                A, X, B=B, tol=tol, maxiter=maxiter, largest=largest)
    if B is not None or M is not None or Y is not None or kwargs:
        return _host_fallback("lobpcg")(
            A, X, B=B, M=M, Y=Y, tol=tol, maxiter=maxiter,
            largest=largest, **kwargs)
    from ._lobpcg import lobpcg_standard

    matvec, m_rows, n_cols, dtype, dev = _operator_parts(A)
    if m_rows != n_cols:
        raise ValueError("expected square matrix")
    X_complex = (X.is_complex() if isinstance(X, torch.Tensor)
                 else np.iscomplexobj(np.asarray(X)))
    if dtype.is_complex or X_complex:
        # jax's lobpcg_standard does not take complex operands; the
        # JAX package serves complex Hermitian operators through its
        # Lanczos, and so does the port.
        if len(Xshape) != 2 or Xshape[0] != n_cols:
            raise ValueError(f"X must be (n, k) with n={n_cols}")
        k = Xshape[1]
        cdtype = torch.promote_types(dtype, torch.complex64)
        if n_cols > (1 << 15):
            # The Lanczos route stores an (m, n) basis: past this size
            # it loses LOBPCG's O(n k) memory, so scipy serves it.
            return _host_fallback("lobpcg")(
                A, X, tol=tol, maxiter=maxiter, largest=largest)
        which = "LA" if largest else "SA"
        cap = min(n_cols, max(8 * k, 128))
        tries = max(1, min(int(maxiter) if maxiter is not None else 6,
                           10))
        seed = _block_seed(X, cdtype)
        from scipy.sparse.linalg import ArpackNoConvergence

        try:
            w, V = _lanczos_eigsh(
                matvec, n_cols, cdtype, dev, k, which, seed, None, tries,
                (tol if tol else 0), True, max_rank=cap)
        except ArpackNoConvergence:
            # One pass at the full capped subspace (tol=inf accepts its
            # Ritz pairs): the best subspace the escalation reached.
            warnings.warn(
                "lobpcg (native Lanczos route) did not converge to the "
                "requested tolerance; returning the current "
                "approximation (scipy-compatible behavior)",
                UserWarning, stacklevel=2)
            w, V = _lanczos_eigsh(
                matvec, n_cols, cdtype, dev, k, which, seed, cap, 1,
                np.inf, True, max_rank=cap)
        order = torch.argsort(w, descending=largest)
        return w[order], V[:, order]
    X = as_tensor(X, dev).to(dtype)
    if X.dim() != 2 or X.shape[0] != n_cols:
        raise ValueError(f"X must be (n, k) with n={n_cols}")
    if 5 * X.shape[1] >= n_cols:
        # lobpcg_standard requires 5k < n; scipy serves these.
        return _host_fallback("lobpcg")(
            A, X, tol=tol, maxiter=maxiter, largest=largest)

    matmat = _block(matvec)

    def mv_block(S):
        AS = matmat(S)
        return AS if largest else -AS

    iters = int(maxiter) if maxiter is not None else 20
    theta, U, _ = lobpcg_standard(mv_block, X, m=max(iters, 1), tol=tol)
    w = theta if largest else -theta
    order = torch.argsort(w, descending=largest)
    return w[order], U[:, order]


# ---------------------------------------------------------------- svds


def svds(A, k=6, ncv=None, tol=0, which="LM", v0=None, maxiter=None,
         return_singular_vectors=True, **kwargs):
    """k largest singular triplets (scipy ``svds``).

    Lanczos on the Gram operator ``v -> A^H (A v)`` (two SpMVs a step,
    ``A^H A`` never formed), then ``U = A V / s`` in one block apply.
    ``which='SM'`` runs shift-invert at 0 on the Gram operator, with
    scipy on the host as the fallback when the inexact inverse stagnates
    (a rank-deficient A, or kappa(A)^2 past the inner solver)."""
    if which not in ("LM", "SM") or kwargs:
        return _host_fallback("svds")(
            A, k=k, ncv=ncv, tol=tol, which=which, v0=v0,
            maxiter=maxiter,
            return_singular_vectors=return_singular_vectors, **kwargs)
    op = _linalg.make_linear_operator(A)
    matvec, m_rows, n_cols, dtype, dev = _operator_parts(op)
    if not (0 < k < min(m_rows, n_cols)):
        raise ValueError(
            f"k={k} must satisfy 0 < k < min(shape)={min(m_rows, n_cols)}")

    try:
        op.rmatvec(torch.zeros((m_rows,), dtype=dtype, device=dev))
        has_rmatvec = True
    except NotImplementedError:
        has_rmatvec = False

    if has_rmatvec:
        def gram(v):
            return op.rmatvec(op.matvec(v))
    else:
        # Transpose a sparse operand once.
        AT = A.transpose() if hasattr(A, "transpose") else None
        if AT is None:
            return _host_fallback("svds")(
                A, k=k, ncv=ncv, tol=tol, which=which, v0=v0,
                maxiter=maxiter,
                return_singular_vectors=return_singular_vectors, **kwargs)

        def gram(v):
            return AT @ op.matvec(v)

    if which == "SM":
        from scipy.sparse.linalg import ArpackNoConvergence

        if m_rows < n_cols:
            # A wide operator's Gram matrix is singular by construction:
            # the probe would spend a whole MINRES budget to find it.
            return _host_fallback("svds")(
                A, k=k, ncv=ncv, tol=tol, which="SM", v0=v0,
                maxiter=maxiter,
                return_singular_vectors=return_singular_vectors)
        try:
            w, V = _eigsh_shift_invert(
                gram, int(n_cols), dtype, dev, int(k), 0.0, "LM", v0, ncv,
                maxiter, tol, True, name="svds")
        except ArpackNoConvergence:
            return _host_fallback("svds")(
                A, k=k, ncv=ncv, tol=tol, which="SM", v0=v0,
                maxiter=maxiter,
                return_singular_vectors=return_singular_vectors)
    else:
        w, V = _lanczos_eigsh(gram, int(n_cols), dtype, dev, int(k), "LA",
                              v0, ncv, maxiter, tol, True)
    s = torch.sqrt(torch.clamp_min(w, 0.0))        # ascending (scipy)
    if not return_singular_vectors:
        return s
    AV = op.matmat(V)
    U = AV / torch.where(s > 0, s, 1.0).to(AV.dtype)[None, :]
    return U, s, V.T


# ---------------------------------------------------------------- Arnoldi


def _arnoldi(matvec, v0, m: int):
    """m-step Arnoldi with full reorthogonalisation, applied twice.

    Returns (V, H): V (m, n) orthonormal on the device, and on the host
    the (m + 1, m) upper Hessenberg with H[j+1, j] the recurrence norms.
    A run of steps makes no host synchronisation and one fetch (H and
    the breakdown flags); breakdowns restart as in ``_lanczos``."""
    n = v0.shape[0]
    dtype = v0.dtype
    rdtype = dtype.to_real()
    eps = torch.finfo(rdtype).eps
    dev = v0.device
    V = torch.empty((m, n), dtype=dtype, device=dev)
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    broke = torch.zeros((m,), dtype=torch.bool, device=dev)
    v = v0
    start = 0
    while True:
        for j in range(start, m):
            V[j] = v
            Vj = V[:j + 1]
            w = matvec(v).to(dtype)
            # Gram-Schmidt by blocks, applied twice; the projections are
            # H's column j.
            h = Vj.conj() @ w
            w = w - Vj.T @ h
            h2 = Vj.conj() @ w
            w = w - Vj.T @ h2
            h = h + h2
            beta = torch.linalg.vector_norm(w).to(rdtype)
            flag = beta <= 100 * eps * torch.clamp_min(h.abs().max(), 1.0)
            v = w / torch.where(beta == 0, 1.0, beta).to(dtype)
            H[:j + 1, j] = h
            H[j + 1, j] = torch.where(flag, torch.zeros_like(beta),
                                      beta).to(dtype)
            broke[j] = flag
        host = _fetch(torch.cat([H.reshape(-1), broke.to(dtype)]))
        j0 = _first_restart(host[(m + 1) * m:].real, start, m)
        if j0 is None:
            return V, host[:(m + 1) * m].reshape(m + 1, m)
        v = _restart_direction(V[:j0 + 1], 11, j0, rdtype, dtype)
        start = j0 + 1


def _select_ritz(w, k, which):
    if which == "LM":
        sel = np.argsort(np.abs(w))[-k:]
    elif which == "SM":
        # Under shift-invert (the only route here): smallest |nu| =
        # farthest from sigma, ARPACK's transformed semantics.
        sel = np.argsort(np.abs(w))[:k]
    elif which == "LR":
        sel = np.argsort(np.real(w))[-k:]
    elif which == "SR":
        sel = np.argsort(np.real(w))[:k]
    elif which == "LI":
        sel = np.argsort(np.imag(w))[-k:]
    else:  # SI
        sel = np.argsort(np.imag(w))[:k]
    return sel


def eigs(A, k=6, M=None, sigma=None, which="LM", v0=None, ncv=None,
         maxiter=None, tol=0, return_eigenvectors=True, **kwargs):
    """k eigenpairs of a general (non-symmetric) operator (scipy
    ``eigs``).

    The standard problem with ``which`` in {LM, LR, SR, LI, SI} runs the
    restarted Arnoldi above, in real arithmetic for a real operator.
    Shift-invert ``sigma`` runs Arnoldi on ``(A - sigma I)^{-1}`` with
    an inexact BiCGSTAB inner apply; ``which`` then refers to ``nu =
    1/(lambda - sigma)``.  ``which='SM'`` without sigma is shift-invert
    at 0, with host ARPACK as the fallback when the inexact inverse
    stagnates.  Generalized pencils (positive-definite M): Arnoldi on
    ``M^{-1} A`` (inner CG) without sigma, on ``(A - sigma M)^{-1} M``
    (inner BiCGSTAB) with it (``_eigs_generalized``), with host fallback
    when an inner-solve probe stagnates.  Eigenvalues return complex,
    as scipy's."""
    native_which = ("LM", "LR", "SR", "LI", "SI")
    if M is not None and not kwargs and (
            which in native_which or which == "SM"):
        from scipy.sparse.linalg import ArpackNoConvergence

        sig, wch = sigma, which
        if which == "SM" and sigma is None:
            sig, wch = 0.0, "LM"     # smallest |lambda| of the pencil
        try:
            return _eigs_generalized(
                A, M, int(k), (None if sig is None else complex(sig)),
                wch, v0, ncv, maxiter, tol, return_eigenvectors)
        except ArpackNoConvergence:
            return _host_fallback("eigs")(
                A, k=k, M=M, sigma=sigma, which=which, v0=v0, ncv=ncv,
                maxiter=maxiter, tol=tol,
                return_eigenvectors=return_eigenvectors)
    if which == "SM" and sigma is None and M is None and not kwargs:
        from scipy.sparse.linalg import ArpackNoConvergence

        try:
            return _eigs_shift_invert(A, int(k), complex(0.0), "LM",
                                      v0, ncv, maxiter, tol,
                                      return_eigenvectors)
        except ArpackNoConvergence:
            return _host_fallback("eigs")(
                A, k=k, which="SM", v0=v0, ncv=ncv, maxiter=maxiter,
                tol=tol, return_eigenvectors=return_eigenvectors)
    if (M is not None
            or which not in native_which + ("SM",) or kwargs):
        return _host_fallback("eigs")(
            A, k=k, M=M, sigma=sigma, which=which, v0=v0, ncv=ncv,
            maxiter=maxiter, tol=tol,
            return_eigenvectors=return_eigenvectors, **kwargs)
    if sigma is not None:
        # A sigma close to an eigenvalue stagnates the inexact BiCGSTAB
        # inverse where scipy's splu succeeds: those go to host ARPACK.
        from scipy.sparse.linalg import ArpackNoConvergence

        try:
            return _eigs_shift_invert(A, int(k), complex(sigma), which,
                                      v0, ncv, maxiter, tol,
                                      return_eigenvectors)
        except ArpackNoConvergence:
            return _host_fallback("eigs")(
                A, k=k, sigma=sigma, which=which, v0=v0, ncv=ncv,
                maxiter=maxiter, tol=tol,
                return_eigenvectors=return_eigenvectors)
    matvec, m_rows, n_cols, dtype, dev = _operator_parts(A)
    if m_rows != n_cols:
        raise ValueError("expected square matrix")
    n = n_cols
    if not (0 < k < n - 1):
        raise ValueError(f"k={k} must satisfy 0 < k < n - 1 = {n - 1}")

    # A real operator's Krylov basis from a real start is real: the
    # recurrence runs in real arithmetic, and only the small host eig
    # and the Ritz combination go complex.
    cdtype = torch.promote_types(dtype, torch.complex64)
    basis_dtype = dtype
    mv = matvec
    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(n)
    else:
        v0 = as_tensor(v0, dev)
        if v0.is_complex() and not dtype.is_complex:
            # A complex start on a real operator: a complex basis, two
            # real matvecs a step.
            basis_dtype = cdtype
            mv = _complex_matvec(matvec, dtype, cdtype)
    v0 = as_tensor(v0, dev).to(basis_dtype)
    v0 = v0 / torch.linalg.vector_norm(v0)
    return _arnoldi_eigs(mv, n, cdtype, k, which, v0, ncv, maxiter,
                         tol, return_eigenvectors)


def _arnoldi_eigs(mv, n, cdtype, k, which, v0, ncv, maxiter, tol,
                  return_eigenvectors, transform=None):
    """Restarted-Arnoldi driver: escalate the subspace until the Ritz
    residuals converge, then map the Ritz values through ``transform``
    (the shift-invert back-transform; the residual control stays in the
    operator's own spectrum, as in ARPACK)."""
    rdtype = cdtype.to_real()
    dev = v0.device
    atol, m, tries = _escalation_params(tol, rdtype, ncv, k, n,
                                        maxiter, min_extra=2)
    for try_i in range(tries):
        if try_i:
            m = min(n, 2 * m)
        V, Hh = _arnoldi(mv, v0, m=m)
        Hm = Hh[:m, :m]
        beta_last = float(abs(Hh[m, m - 1]))
        w, y = np.linalg.eig(Hm)
        sel = _select_ritz(w, k, which)
        w_k = w[sel]
        y_k = y[:, sel]
        resid = beta_last * np.abs(y_k[-1, :])
        scale = np.maximum(np.abs(w_k), 1.0)
        if np.all(resid <= atol * scale) or m >= n:
            break
    converged = bool(np.all(resid <= atol * scale)) or m >= n
    lam = transform(w_k) if transform is not None else w_k
    # scipy: eigs eigenvalues are always complex.
    lam = np.asarray(lam).astype(to_numpy_dtype(cdtype))
    if converged and not return_eigenvectors:
        return _on(lam, dev)
    X = _basis_times(V, y_k, cdtype)
    _require_converged(resid, atol, scale, m, n, lam, X)
    if not return_eigenvectors:
        return _on(lam, dev)
    return _on(lam, dev), X


def _promote_real_operators(matvecs, dtypes, cdtype, extra_complex: bool):
    """Complex promotion of the non-symmetric drivers: ``(base_dtype,
    wrapped, guards)``, the working dtype, the matvecs promoted to a
    complex basis when anything requires it, and complex guard matvecs
    for the residual referees."""
    pdt = dtypes[0]
    for d in dtypes[1:]:
        pdt = torch.promote_types(pdt, d)
    if pdt.is_complex or not extra_complex:
        base = pdt
        wrapped = list(matvecs)
    else:
        base = cdtype
        wrapped = [_complex_matvec(mv, d, cdtype)
                   for mv, d in zip(matvecs, dtypes)]
    if base.is_complex:
        guards = list(wrapped)
    else:
        guards = [_complex_matvec(mv, d, cdtype)
                  for mv, d in zip(matvecs, dtypes)]
    return base, wrapped, guards


def _si_back_transform(sigma, rdtype, cdtype):
    """``lambda = sigma + 1/nu`` of the non-symmetric shift-invert
    drivers (zero nu guarded by tiny)."""

    def back(nu):
        tiny = float(torch.finfo(rdtype).tiny)
        safe = np.where(nu == 0, tiny, nu)
        return (complex(sigma) + 1.0 / safe).astype(to_numpy_dtype(cdtype))

    return back


def _eigs_shift_invert(A, k, sigma, which, v0, ncv, maxiter, tol,
                       return_eigenvectors):
    """Shift-invert ``eigs``: Arnoldi on ``(A - sigma I)^{-1}`` with the
    inexact BiCGSTAB inner apply.  A complex sigma (or complex start) on
    a real operator promotes the basis to complex, two real matvecs an
    inner apply."""
    matvec, m_rows, n_cols, dtype, dev = _operator_parts(A)
    if m_rows != n_cols:
        raise ValueError("expected square matrix")
    n = n_cols
    if not (0 < k < n - 1):
        raise ValueError(f"k={k} must satisfy 0 < k < n - 1 = {n - 1}")
    cdtype = torch.promote_types(dtype, torch.complex64)
    rdtype = cdtype.to_real()
    if v0 is not None:
        v0 = as_tensor(v0, dev)
    extra_complex = sigma.imag != 0 or (v0 is not None and v0.is_complex())
    base_dtype, (base_mv,), (check_mv,) = _promote_real_operators(
        [matvec], [dtype], cdtype, extra_complex)
    sig_val = complex(sigma) if base_dtype.is_complex else float(sigma.real)
    atol_outer = _outer_atol(tol, rdtype)
    op, inner_atol = _shift_invert_op(base_mv, sig_val, base_dtype, dev, n,
                                      atol_outer, sym=False)
    _probe_inverse(base_mv, op, sig_val, base_dtype, dev, n, inner_atol,
                   "eigs")
    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(n)
    v0 = as_tensor(v0, dev).to(base_dtype)
    v0 = v0 / torch.linalg.vector_norm(v0)
    back = _si_back_transform(sigma, rdtype, cdtype)
    # X is always formed: the original-spectrum check catches a
    # stagnated inner solve.
    lam, X = _arnoldi_eigs(op, n, cdtype, k, which, v0, ncv, maxiter,
                           tol, True, transform=back)
    _check_original_residuals(check_mv, to_numpy(lam), X, atol_outer,
                              "eigs")
    if not return_eigenvectors:
        return lam
    return lam, X


def _eigs_generalized(A, M, k, sigma, which, v0, ncv, maxiter, tol,
                      return_eigenvectors):
    """Generalized (non-symmetric) ``eigs``: Arnoldi on ``M^{-1} A``
    (sigma None: the operator's eigenvalues are the pencil's) or on
    ``(A - sigma M)^{-1} M`` (shift-invert, back-transform ``lambda =
    sigma + 1/nu``).  Inner solves: CG on the positive-definite M,
    BiCGSTAB on the shifted pencil, both with normalized right-hand
    sides; the pencil-residual guard referees them."""
    matvec_a, ar, ac, adt, dev = _operator_parts(A)
    mv_m, mr, mc, mdt, _ = _operator_parts(M)
    if ar != ac:
        raise ValueError("expected square matrix")
    if (mr, mc) != (ar, ac):
        raise ValueError(f"M has shape {(mr, mc)}, expected {(ar, ac)}")
    n = ac
    if not (0 < k < n - 1):
        raise ValueError(f"k={k} must satisfy 0 < k < n - 1 = {n - 1}")
    cdtype = torch.promote_types(torch.promote_types(adt, mdt),
                                 torch.complex64)
    rdtype = cdtype.to_real()
    if v0 is not None:
        v0 = as_tensor(v0, dev)
    extra_complex = ((sigma is not None and sigma.imag != 0)
                     or (v0 is not None and v0.is_complex()))
    base_dtype, (base_a, base_m), (guard_a, guard_m) = (
        _promote_real_operators([matvec_a, mv_m], [adt, mdt], cdtype,
                                extra_complex))
    atol_outer = _outer_atol(tol, rdtype)
    inner_atol, inner_maxiter = _inner_solver_params(atol_outer, rdtype,
                                                     n)
    ident = lambda r: r  # noqa: E731

    if sigma is None:
        solve = _normalized_rhs_solver(
            lambda b: _linalg._cg_loop(base_m, ident, b,
                                       torch.zeros_like(b), inner_atol,
                                       inner_maxiter, 10)[0])
        _probe_apply(base_m, solve, n, base_dtype, dev, inner_atol,
                     "generalized eigs")
        transform = None
    else:
        sig_val = (complex(sigma) if base_dtype.is_complex
                   else float(sigma.real))
        sig_dev = torch.tensor(sig_val, dtype=base_dtype, device=dev)

        def shifted(x):
            return base_a(x) - sig_dev * base_m(x)

        solve = _normalized_rhs_solver(
            lambda b: _linalg._bicgstab_loop(shifted, ident, b,
                                             torch.zeros_like(b),
                                             inner_atol, inner_maxiter,
                                             10)[0])
        _probe_apply(shifted, solve, n, base_dtype, dev, inner_atol,
                     "generalized eigs shift-invert")
        transform = _si_back_transform(sigma, rdtype, cdtype)

    def op(v):
        return solve(base_m(v)) if sigma is not None else solve(base_a(v))

    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(n)
    v0 = as_tensor(v0, dev).to(base_dtype)
    v0 = v0 / torch.linalg.vector_norm(v0)
    lam, X = _arnoldi_eigs(op, n, cdtype, k, which, v0, ncv, maxiter,
                           tol, True, transform=transform)
    # The pencil-residual referee in complex arithmetic (X is complex).
    _pencil_residual_guard(guard_a, guard_m, to_numpy(lam), X, atol_outer,
                           rdtype)
    if not return_eigenvectors:
        return lam
    return lam, X
