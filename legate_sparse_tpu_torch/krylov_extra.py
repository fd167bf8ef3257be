# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""MINRES, LSQR, LSMR and a solve that autograd differentiates.

Mirrors ``legate_sparse_tpu/krylov_extra.py``: the Givens helpers
``_sym_ortho`` (``:38``) and ``_givens`` (``:47``, which ``gmres``
uses too), ``_make_normalize`` (``:68``), ``_safe_denom`` (``:78``),
``minres`` (``:85-213``, with ``shift=``), ``lsqr`` (``:216-363``),
``lsmr`` (``:366-571``) and ``differentiable_solve`` (``:574-638``).

The JAX package runs each solve as one ``lax.while_loop``.  Here each
is a Python loop over device tensors with the same recurrences, the
scalars kept as 0-d tensors in the working precision, and the stopping
rules tested only at the JAX package's cadence (``iters %
conv_test_iters == 0`` or ``iters >= maxiter - 1``), so the iteration
counts match; the one host sync of a check fetches all of its flags at
once.  A zero right-hand side or an exact start stops before the loop,
as the JAX loops' initial ``done`` does (one fetch).

``minres`` with a ``callback`` or scipy's diagnostic keywords, ``lsqr``
with ``calc_var``/``show`` and ``lsmr`` with ``show`` run scipy on the
host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["minres", "lsqr", "lsmr", "differentiable_solve"]


def _sym_ortho(a, b):
    """Stable Givens rotation (c, s, r) with r = hypot(a, b)."""
    r = torch.hypot(a, b)
    zero = r == 0
    safe = torch.where(zero, torch.ones_like(r), r)
    c = torch.where(zero, torch.ones_like(a), a / safe)
    s = torch.where(zero, torch.zeros_like(b), b / safe)
    return c, s, r


def _givens(a, b):
    """Givens rotation (c, s) annihilating ``b``, complex-capable:

        [ c        s      ] [a]   [r]
        [-conj(s)  conj(c)] [b] = [0]

    with r = hypot(|a|, |b|) real and |c|^2 + |s|^2 = 1; for real
    operands ``_sym_ortho``'s (c, s)."""
    if not (a.is_complex() or b.is_complex()):
        c, s, _ = _sym_ortho(a, b)
        return c, s
    r = torch.hypot(a.abs(), b.abs())
    zero = r == 0
    safe = torch.where(zero, torch.ones_like(r), r).to(a.dtype)
    c = torch.where(zero, torch.ones_like(a), a.conj() / safe)
    s = torch.where(zero, torch.zeros_like(b), b.conj() / safe)
    return c, s


def _make_normalize(dtype, rdt):
    """(v / ||v||, ||v||), the zero vector left as it is."""
    def normalize(v):
        nrm = torch.linalg.vector_norm(v).to(rdt)
        return v / torch.where(nrm == 0, 1.0, nrm).to(dtype), nrm

    return normalize


def _safe_denom(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def _setup(A, b, x0, name: str):
    """Operator, ``b`` (1-D, promoted to ``result_type(A, b)``), the
    start vector (zeros of the operator's columns without ``x0``) and
    the device: the operator's, else ``b``'s."""
    from .linalg import _setup as _linalg_setup
    from .linalg import _x0

    A_op, b, _, _, dev = _linalg_setup(A, b, None, None, name,
                                       square=False)
    return A_op, b, _x0(x0, b, A_op.shape[1]), dev


def _fetch(*flags) -> list:
    return torch.stack(list(flags)).tolist()


def _scalar(value, rdt, dev):
    return torch.as_tensor(value, dtype=rdt, device=dev)


# ------------------------------------------------------------------ MINRES


def _minres_loop(A_mv, M_mv, b, x0, shift, atol, maxiter: int,
                 conv_test_iters: int):
    """Paige & Saunders MINRES; ``atol`` a float or a 0-d tensor."""
    from .linalg import _vdot

    dtype = b.dtype
    rdt = dtype.to_real()
    dev = b.device
    eps = torch.finfo(rdt).eps

    def op(v):
        return A_mv(v) - shift * v

    r1 = b - op(x0)
    y = M_mv(r1)
    beta1 = torch.sqrt(torch.clamp_min(
        _vdot(r1, y).real, 0)).to(rdt)
    atol = _scalar(atol, rdt, dev)
    x, r2 = x0, r1
    w = torch.zeros_like(b)
    w2 = torch.zeros_like(b)
    oldb = torch.zeros((), dtype=rdt, device=dev)
    beta = beta1
    dbar = torch.zeros((), dtype=rdt, device=dev)
    epsln = torch.zeros((), dtype=rdt, device=dev)
    phibar = beta1
    cs = torch.full((), -1.0, dtype=rdt, device=dev)
    sn = torch.zeros((), dtype=rdt, device=dev)
    iters = 0
    if _fetch(beta1 == 0)[0]:
        return x, iters
    while iters < maxiter:
        safe_beta = torch.where(beta == 0, 1.0, beta)
        v = y / safe_beta.to(dtype)
        y = op(v)
        if iters > 0:
            y = y - (beta / torch.where(oldb == 0, 1.0, oldb)).to(dtype) * r1
        alfa = _vdot(v, y).real.to(rdt)
        y = y - (alfa / safe_beta).to(dtype) * r2
        r1, r2 = r2, y
        y = M_mv(r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp_min(_vdot(r2, y).real, 0)).to(rdt)
        # Givens QR update of the tridiagonal.
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        cs, sn, gamma = _sym_ortho(gbar, beta)
        gamma = torch.clamp_min(gamma, eps)
        phi = cs * phibar
        phibar = sn * phibar
        # Solution update.
        denom = (1.0 / gamma).to(dtype)
        w1, w2 = w2, w
        w = (v - oldeps.to(dtype) * w1 - delta.to(dtype) * w2) * denom
        x = x + phi.to(dtype) * w
        iters += 1
        if ((iters % conv_test_iters == 0 or iters >= maxiter - 1)
                and _fetch(phibar <= atol)[0]):
            break
    return x, iters


def minres(A, b, x0=None, *, shift=0.0, tol=None, maxiter=None, M=None,
           callback=None, rtol=1e-5, atol=0.0, conv_test_iters: int = 25,
           **kwargs):
    """MINRES for symmetric (indefinite allowed) ``(A - shift I) x = b``
    (scipy-shaped; returns ``(x, iters)`` like ``cg``).  ``M`` must be
    SPD, as scipy requires.  With a ``callback`` or scipy's ``show`` /
    ``check`` keywords scipy solves on the host, counting iterations
    through its callback."""
    from .coverage import scipy_fallback
    from .linalg import (IdentityOperator, _get_atol_rtol,
                         make_linear_operator)

    if callback is not None or kwargs:
        import scipy.sparse.linalg as _ssl

        count = [0]

        def counting_callback(xk):
            count[0] += 1
            if callback is not None:
                callback(xk)

        x_out, _info = scipy_fallback(_ssl.minres, "linalg.minres")(
            A, b, x0=x0, shift=shift, maxiter=maxiter, M=M,
            callback=counting_callback,
            rtol=(tol if tol is not None else rtol), **kwargs)
        return x_out, count[0]

    A_op, b, x, _ = _setup(A, b, x0, "minres")
    M_op = (IdentityOperator(A_op.shape, dtype=A_op.dtype)
            if M is None else make_linear_operator(M))
    bnrm = float(torch.linalg.vector_norm(b))
    atol, _ = _get_atol_rtol(bnrm, tol, atol, rtol)
    if maxiter is None:
        maxiter = 5 * b.shape[0]
    shift = torch.as_tensor(shift, dtype=b.dtype, device=b.device)
    return _minres_loop(A_op.matvec, M_op.matvec, b, x, shift, atol,
                        int(maxiter), int(conv_test_iters))


# -------------------------------------------------------------------- LSQR


def _lsqr_loop(A_mv, At_mv, b, x, damp: float, atol: float, btol: float,
               maxiter: int, conv_test_iters: int):
    """Golub-Kahan bidiagonalization with scipy's stopping rules 1 and
    2.  Returns the final state as a dict."""
    dtype = b.dtype
    rdt = dtype.to_real()
    dev = b.device
    eps = torch.finfo(rdt).eps
    normalize = _make_normalize(dtype, rdt)

    u, beta0 = normalize(b - A_mv(x))
    v, alfa = normalize(At_mv(u))
    w = v
    rhobar, phibar = alfa, beta0
    anorm2 = torch.zeros((), dtype=rdt, device=dev)
    psi2 = torch.zeros((), dtype=rdt, device=dev)
    rnorm, arnorm = beta0, alfa * beta0
    xnorm = torch.linalg.vector_norm(x).to(rdt)
    damp, atol, btol = (_scalar(t, rdt, dev) for t in (damp, atol, btol))
    bnorm = torch.linalg.vector_norm(b).to(rdt)
    iters = 0
    stop1 = stop2 = False
    done = any(_fetch(beta0 == 0, alfa == 0))
    while not done and iters < maxiter:
        # Bidiagonalization step.
        u, beta = normalize(A_mv(v) - alfa.to(dtype) * u)
        alfa_old = alfa
        v, alfa = normalize(At_mv(u) - beta.to(dtype) * v)
        # Eliminate the damping term.
        rhobar1 = torch.sqrt(rhobar ** 2 + damp ** 2)
        cs1 = rhobar / torch.where(rhobar1 == 0, 1.0, rhobar1)
        sn1 = damp / torch.where(rhobar1 == 0, 1.0, rhobar1)
        psi = sn1 * phibar
        phibar1 = cs1 * phibar
        # Givens rotation on the bidiagonal.
        cs, sn, rho = _sym_ortho(rhobar1, beta)
        rho_safe = torch.where(rho == 0, 1.0, rho)
        theta = sn * alfa
        rhobar = -cs * alfa
        phi = cs * phibar1
        phibar = sn * phibar1
        x = x + (phi / rho_safe).to(dtype) * w
        w = v - (theta / rho_safe).to(dtype) * w
        # Norm estimates (Frobenius accumulation).
        anorm = torch.sqrt(anorm2)
        anorm2 = anorm2 + alfa_old ** 2 + beta ** 2 + damp ** 2
        rnorm = torch.sqrt(phibar ** 2 + psi2 + psi ** 2)
        psi2 = psi2 + psi ** 2
        arnorm = alfa * torch.abs(sn * phi)
        xnorm = torch.linalg.vector_norm(x).to(rdt)
        iters += 1
        if iters % conv_test_iters == 0 or iters >= maxiter - 1:
            tol1 = btol * bnorm + atol * anorm * xnorm
            stop1, stop2 = _fetch(rnorm <= tol1,
                                  arnorm <= atol * anorm * rnorm + eps)
            done = stop1 or stop2
    return dict(x=x, iters=iters, stop1=stop1, stop2=stop2, rnorm=rnorm,
                psi2=psi2, anorm2=anorm2, arnorm=arnorm, xnorm=xnorm)


def lsqr(A, b, damp=0.0, atol=1e-6, btol=1e-6, conlim=1e8, iter_lim=None,
         show=False, calc_var=False, x0=None, conv_test_iters: int = 10):
    """Least-squares solve of ``min ||A x - b||^2 + damp^2 ||x||^2``
    (scipy ``lsqr``).

    Returns scipy's 10-tuple ``(x, istop, itn, r1norm, r2norm, anorm,
    acond, arnorm, xnorm, var)`` with ``x`` a tensor: ``acond`` is not
    estimated (0), ``var`` is zeros (scipy's ``calc_var=False``);
    ``calc_var=True`` or ``show`` run scipy on the host."""
    from .coverage import scipy_fallback

    if calc_var or show:
        import scipy.sparse.linalg as _ssl

        return scipy_fallback(_ssl.lsqr, "linalg.lsqr")(
            A, b, damp=damp, atol=atol, btol=btol, conlim=conlim,
            iter_lim=iter_lim, show=show, calc_var=calc_var, x0=x0)

    A_op, b, x, dev = _setup(A, b, x0, "lsqr")
    n = A_op.shape[1]
    if iter_lim is None:
        iter_lim = 2 * n
    zeros = torch.zeros(n, dtype=torch.float64, device=dev)
    if float(torch.linalg.vector_norm(b)) == 0.0:
        # scipy: b = 0 gives the exact solution x = 0, istop = 0.
        return (torch.zeros_like(x), 0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                zeros)
    out = _lsqr_loop(A_op.matvec, A_op.rmatvec, b, x, float(damp),
                     float(atol), float(btol), int(iter_lim),
                     int(conv_test_iters))
    itn = out["iters"]
    r2norm = float(out["rnorm"])
    r1norm = float(np.sqrt(max(r2norm ** 2 - float(out["psi2"]), 0.0)))
    # scipy's istop: 1 Ax = b solved to tolerance, 2 least-squares
    # solution, 0 exact at entry, 7 iteration limit.
    if out["stop1"]:
        istop = 1
    elif out["stop2"]:
        istop = 2
    elif itn == 0:
        istop = 0
    else:
        istop = 7
    return (out["x"], istop, itn, r1norm, r2norm,
            float(torch.sqrt(out["anorm2"])), 0.0, float(out["arnorm"]),
            float(out["xnorm"]), zeros)


# -------------------------------------------------------------------- LSMR


def _lsmr_loop(A_mv, At_mv, b, x, damp: float, atol: float, btol: float,
               conlim: float, maxiter: int, conv_test_iters: int):
    """Fong & Saunders LSMR: the bidiagonalization with a second Givens
    chain minimizing ||A^T r||, and scipy's stopping tests 1-6."""
    dtype = b.dtype
    rdt = dtype.to_real()
    dev = b.device
    eps = torch.finfo(rdt).eps
    normalize = _make_normalize(dtype, rdt)

    def scalar(value):
        return _scalar(value, rdt, dev)

    u, beta0 = normalize(b - A_mv(x))
    v, alpha = normalize(At_mv(u))
    h, hbar = v, torch.zeros_like(v)
    alphabar = alpha
    rho = rhobar = cbar = scalar(1.0)
    sbar = zeta = scalar(0.0)
    zetabar = alpha * beta0
    betadd, betad = beta0, scalar(0.0)
    rhodold, tautildeold = scalar(1.0), scalar(0.0)
    thetatilde, d2 = scalar(0.0), scalar(0.0)
    normA2, normA = alpha ** 2, alpha
    normr, normar = beta0, alpha * beta0
    normx = torch.linalg.vector_norm(x).to(rdt)
    maxrbar = scalar(0.0)
    minrbar = scalar(np.finfo(np.float64).max)
    rhotemp = scalar(1.0)
    ctol = scalar(0.0 if conlim <= 0 else 1.0 / conlim)
    damp, atol, btol = scalar(damp), scalar(atol), scalar(btol)
    bnorm = torch.linalg.vector_norm(b).to(rdt)
    iters = 0
    stops = [False] * 6
    done = any(_fetch(beta0 == 0, alpha == 0))
    while not done and iters < maxiter:
        iters += 1
        u, beta = normalize(A_mv(v) - alpha.to(dtype) * u)
        v, alpha = normalize(At_mv(u) - beta.to(dtype) * v)

        chat, shat, alphahat = _sym_ortho(alphabar, damp)

        rhoold = rho
        c, s, rho = _sym_ortho(alphahat, beta)
        thetanew = s * alpha
        alphabar = c * alpha

        rhobarold = rhobar
        zetaold = zeta
        thetabar = sbar * rho
        rhotemp = cbar * rho
        cbar, sbar, rhobar = _sym_ortho(rhotemp, thetanew)
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar

        denom_h = torch.where(rhoold * rhobarold == 0, 1.0,
                              rhoold * rhobarold)
        hbar = h - (thetabar * rho / denom_h).to(dtype) * hbar
        denom_x = torch.where(rho * rhobar == 0, 1.0, rho * rhobar)
        x = x + (zeta / denom_x).to(dtype) * hbar
        h = v - (thetanew / torch.where(rho == 0, 1.0, rho)).to(dtype) * h

        # ||r|| estimate (the paper's second triangular solve).
        betaacute = chat * betadd
        betacheck = -shat * betadd
        betahat = c * betaacute
        betadd = -s * betaacute
        thetatildeold = thetatilde
        ctildeold, stildeold, rhotildeold = _sym_ortho(rhodold, thetabar)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * betad + ctildeold * betahat
        tautildeold = ((zetaold - thetatildeold * tautildeold)
                       / torch.where(rhotildeold == 0, 1.0, rhotildeold))
        taud = (zeta - thetatilde * tautildeold) \
            / torch.where(rhodold == 0, 1.0, rhodold)
        d2 = d2 + betacheck ** 2
        normr = torch.sqrt(d2 + (betad - taud) ** 2 + betadd ** 2)

        # scipy's order: beta^2 enters normA for this iteration's tests,
        # alpha^2 only for the next.
        normA = torch.sqrt(normA2 + beta ** 2)
        normA2 = normA2 + beta ** 2 + alpha ** 2
        normar = torch.abs(zetabar)
        normx = torch.linalg.vector_norm(x).to(rdt)
        maxrbar = torch.maximum(maxrbar, rhobarold)
        if iters > 1:
            minrbar = torch.minimum(minrbar, rhobarold)

        if iters % conv_test_iters == 0 or iters >= maxiter - 1:
            condA = (torch.maximum(maxrbar, rhotemp)
                     / torch.clamp_min(torch.minimum(minrbar, rhotemp), eps))
            test1 = normr / _safe_denom(bnorm)
            test2 = normar / _safe_denom(normA * normr)
            test3 = 1.0 / _safe_denom(condA)
            t1 = test1 / (1.0 + normA * normx / _safe_denom(bnorm))
            rtol_ = btol + atol * normA * normx / _safe_denom(bnorm)
            stops = _fetch(test1 <= rtol_, test2 <= atol,
                           (ctol > 0) & (test3 <= ctol), 1.0 + t1 <= 1.0,
                           1.0 + test2 <= 1.0, 1.0 + test3 <= 1.0)
            done = any(stops)
    return dict(x=x, iters=iters, stops=stops, normr=normr, normar=normar,
                normA=normA, normx=normx, maxrbar=maxrbar, minrbar=minrbar,
                rhotemp=rhotemp)


def lsmr(A, b, damp=0.0, atol=1e-6, btol=1e-6, conlim=1e8, maxiter=None,
         show=False, x0=None, conv_test_iters: int = 10):
    """Iterative least squares minimizing ||A^T r|| (scipy ``lsmr``).

    Returns scipy's 8-tuple ``(x, istop, itn, normr, normar, norma,
    conda, normx)`` with ``x`` a tensor and scipy's istop (1
    compatible, 2 least squares, 3 condition limit, 4-6 their
    machine-precision forms, 0 zero rhs or exact at entry, 7 iteration
    limit).  ``show`` runs scipy on the host."""
    from .coverage import scipy_fallback

    if show:
        import scipy.sparse.linalg as _ssl

        return scipy_fallback(_ssl.lsmr, "linalg.lsmr")(
            A, b, damp=damp, atol=atol, btol=btol, conlim=conlim,
            maxiter=maxiter, show=show, x0=x0)

    A_op, b, x, _ = _setup(A, b, x0, "lsmr")
    m, n = A_op.shape
    if maxiter is None:
        maxiter = min(m, n)            # scipy's default
    if x0 is None and float(torch.linalg.vector_norm(b)) == 0.0:
        # normar = alpha0 * beta0 = 0 at entry: scipy returns x = 0.
        return (torch.zeros_like(x), 0, 0, 0.0, 0.0, 0.0, 0.0, 0.0)
    out = _lsmr_loop(A_op.matvec, A_op.rmatvec, b, x, float(damp),
                     float(atol), float(btol), float(conlim), int(maxiter),
                     int(conv_test_iters))
    itn = out["iters"]
    conda = float(torch.maximum(out["maxrbar"], out["rhotemp"])
                  / torch.minimum(out["minrbar"], out["rhotemp"]))
    # The smallest rule that fired wins, as scipy assigns them.
    fired = [code for code, hit in enumerate(out["stops"], 1) if hit]
    istop = fired[0] if fired else (0 if itn == 0 else 7)
    return (out["x"], istop, itn, float(out["normr"]),
            float(out["normar"]), float(out["normA"]), conda,
            float(out["normx"]))


# -------------------------------------------------- differentiable solve


class _SymmetricSolve(torch.autograd.Function):
    """``x = A^-1 b`` for a symmetric ``A``: the gradient with respect
    to ``b`` is ``A^-1`` applied to the incoming gradient, one more
    solve (the JAX package's ``custom_linear_solve(..., symmetric=True)``)."""

    @staticmethod
    def forward(ctx, b, solve):
        ctx.solve = solve
        return solve(b)

    @staticmethod
    def backward(ctx, grad_x):
        return ctx.solve(grad_x.contiguous()), None


def differentiable_solve(A, b, method="cg", M=None, rtol=None, atol=0.0,
                         maxiter=None, conv_test_iters: int = 25):
    """A sparse linear solve that autograd differentiates with respect
    to ``b`` (reference ``krylov_extra.py:574-638``).

    The forward pass runs the CG (``method="cg"``, SPD) or MINRES
    (``"minres"``, symmetric indefinite) loop; the backward pass solves
    the same symmetric system for the incoming gradient, with the
    tolerance relative to that right-hand side, so the gradient costs
    one more solve.  ``A`` and ``M`` are constants.  The default
    ``rtol`` is ``sqrt(eps) * 1e-2`` of the working precision."""
    from .linalg import (IdentityOperator, _cg_loop, make_linear_operator)

    if method not in ("cg", "minres"):
        raise ValueError(
            f"method={method!r}: differentiable_solve supports 'cg' "
            "and 'minres' (symmetric operators)")
    A_op, b_in, _, dev = _setup(A, b, None, "differentiable_solve")
    if A_op.shape[0] != A_op.shape[1]:
        raise ValueError("expected square matrix")
    M_op = (IdentityOperator(A_op.shape, dtype=A_op.dtype)
            if M is None else make_linear_operator(M))
    n = b_in.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    rdt = b_in.dtype.to_real()
    if rtol is None:
        rtol = float(np.sqrt(torch.finfo(rdt).eps) * 1e-2)

    def solve(rhs):
        # The tolerance is relative to THIS right-hand side: the
        # backward pass solves for the gradient, whose scale differs
        # from b's.
        a_tol = torch.maximum(_scalar(atol, rdt, dev),
                              rtol * torch.linalg.vector_norm(rhs).to(rdt))
        x0 = torch.zeros_like(rhs)
        if method == "cg":
            x, _ = _cg_loop(A_op.matvec, M_op.matvec, rhs, x0, a_tol,
                            int(maxiter), int(conv_test_iters))
        else:
            x, _ = _minres_loop(A_op.matvec, M_op.matvec, rhs, x0,
                                torch.zeros((), dtype=rhs.dtype,
                                            device=dev),
                                a_tol, int(maxiter), int(conv_test_iters))
        return x

    return _SymmetricSolve.apply(b_in, solve)
