# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``minres``, ``lsqr``, ``lsmr`` and ``differentiable_solve``
against the JAX package's, on the CPU.

Mirrors ``test_krylov_extra.py``.  The same scipy matrices go to both
packages: a symmetric indefinite tridiagonal (random diagonal), an
overdetermined and an underdetermined random sparse matrix (a unit
block keeps the full-rank one well conditioned), and the 2-D Poisson
operator on a 12x12 grid for the gradients.

Tolerances.  In float64 the iteration counts and ``istop`` are equal
and ``x`` agrees at rtol 1e-9 (summation order only, amplified by the
condition number); the returned norm estimates at 1e-8, those of
``A^T r`` looser (``assert_estimates``).  The gradient
of ``<w, x(b)>`` is ``A^-1 w``, one more solve in both packages, held
at 1e-9 to ``jax.grad``'s; ``torch.autograd.gradcheck`` runs in float64
with conv_test_iters 1, where CG reaches the exact solution of the 16
unknowns, so ``x(b)`` is linear in ``b`` to rounding.  float32 counts
may differ by one convergence test and ``x`` agrees at 1e-3 of its
norm (the stopping tolerance times the condition number).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as ssl
import torch

import jax
import jax.numpy as jnp
import legate_sparse_tpu as jsparse
import legate_sparse_tpu.linalg as jlinalg

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch import runtime


@pytest.fixture(autouse=True)
def _cpu():
    runtime.set_device("cpu")
    yield
    runtime.set_device(None)


def pair(A_sp):
    return jsparse.csr_array(A_sp), tsparse.csr_array(A_sp, device="cpu")


def indefinite(n=80, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(n) * 3
    A = sp.diags([np.full(n - 1, 1.0), d, np.full(n - 1, 1.0)], [-1, 0, 1],
                 format="csr")
    return sp.csr_array(A.astype(dtype)), rng.standard_normal(n).astype(dtype)


def tall(m=120, n=40, seed=0):
    rng = np.random.default_rng(seed)
    B = (sp.random(m, n, density=0.08, format="csr", random_state=rng)
         + sp.vstack([sp.eye(n), sp.csr_matrix((m - n, n))]))
    return sp.csr_array(B), rng.standard_normal(m)


def poisson(N=12, dtype=np.float64):
    n = N * N
    off1 = np.full(n - 1, -1.0)
    off1[np.arange(1, N) * N - 1] = 0.0
    A = sp.diags([np.full(n, 4.0), off1, off1, np.full(n - N, -1.0),
                  np.full(n - N, -1.0)], [0, 1, -1, N, -N], format="csr")
    return sp.csr_array(A.astype(dtype))


def assert_close(xt, xj, rtol):
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.detach().numpy(), xj, rtol=rtol,
                               atol=rtol * float(np.abs(xj).max()))


# ----------------------------------------------------------------- minres


@pytest.mark.parametrize("shift,precond", [(0.0, False), (0.5, False),
                                           (0.0, True)])
def test_minres_iterations_equal(shift, precond):
    A_sp, b = indefinite()
    Aj, At = pair(A_sp)
    kw_j, kw_t = {}, {}
    if precond:
        Minv = sp.csr_array(sp.diags([1.0 / (np.abs(A_sp.diagonal()) + 1)],
                                     [0], format="csr"))
        kw_j["M"], kw_t["M"] = pair(Minv)
    xj, itj = jlinalg.minres(Aj, b, shift=shift, rtol=1e-10, maxiter=3000,
                             **kw_j)
    xt, itt = tlinalg.minres(At, torch.from_numpy(b), shift=shift,
                             rtol=1e-10, maxiter=3000, **kw_t)
    assert itt == int(itj) and itt % 25 == 0
    assert_close(xt, xj, 1e-9)
    res = np.linalg.norm((A_sp - shift * sp.eye(80)) @ xt.numpy() - b)
    assert res < 1e-8 * np.linalg.norm(b)


def test_minres_float32_and_callback_fallback():
    A_sp, b = indefinite(dtype=np.float32)
    Aj, At = pair(A_sp)
    xj, itj = jlinalg.minres(Aj, b, rtol=1e-5, maxiter=3000)
    xt, itt = tlinalg.minres(At, torch.from_numpy(b), rtol=1e-5,
                             maxiter=3000)
    assert xt.dtype == torch.float32 and abs(itt - int(itj)) <= 25
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-3 * np.linalg.norm(xj)
    # A callback sends the solve to scipy on the host in both packages.
    seen = []
    x, it = tlinalg.minres(At, torch.from_numpy(b), rtol=1e-5,
                           maxiter=500, callback=seen.append)
    assert it == len(seen) > 0 and isinstance(x, torch.Tensor)
    res = np.linalg.norm(A_sp @ x.numpy() - b) / np.linalg.norm(b)
    assert res < 1e-3


def test_minres_zero_rhs_stops_at_once():
    A_sp, _ = indefinite()
    _, At = pair(A_sp)
    x, it = tlinalg.minres(At, torch.zeros(80, dtype=torch.float64))
    xj, itj = jlinalg.minres(jsparse.csr_array(A_sp), np.zeros(80))
    assert it == int(itj) == 0 and not x.any()


# ------------------------------------------------------------ lsqr, lsmr


def assert_estimates(got, want, small):
    """The norm estimates at rtol 1e-8, those at the indices ``small``
    at 1e-1: ``arnorm``/``normar`` (1e-8 of their start when the loop
    stops) and LSMR's ``conda`` (the extremes of the rotated diagonal)
    come, once the residual's gradient is near rounding, from rotations
    of nearly cancelled numbers.  Up to iteration 15 of this system the
    two packages and scipy agree to 1e-15; from iteration 20 any two of
    them differ there by up to 6%."""
    got = np.array(got, dtype=float)
    want = np.array([float(v) for v in want])
    big = [i for i in range(len(got)) if i not in small]
    np.testing.assert_allclose(got[big], want[big], rtol=1e-8)
    np.testing.assert_allclose(got[small], want[small], rtol=1e-1)


@pytest.mark.parametrize("damp", [0.0, 0.7])
def test_lsqr_overdetermined(damp):
    B_sp, b = tall()
    Bj, Bt = pair(B_sp)
    out_j = jlinalg.lsqr(Bj, b, damp=damp, atol=1e-8, btol=1e-8,
                         iter_lim=2000)
    out_t = tlinalg.lsqr(Bt, torch.from_numpy(b), damp=damp, atol=1e-8,
                         btol=1e-8, iter_lim=2000)
    assert out_t[1:3] == (out_j[1], int(out_j[2]))
    assert_close(out_t[0], out_j[0], 1e-9)
    # r1norm, r2norm, anorm, acond, arnorm, xnorm
    assert_estimates(out_t[3:9], out_j[3:9], small=[4])
    assert out_t[9].shape == (40,) and not out_t[9].any()
    ref = ssl.lsqr(B_sp, b, damp=damp, atol=1e-8, btol=1e-8,
                   iter_lim=2000)
    assert_close(out_t[0], ref[0], 1e-6)


def test_lsqr_underdetermined_x0_and_zero_rhs():
    rng = np.random.default_rng(3)
    C_sp = sp.csr_array(sp.random(40, 120, density=0.15, format="csr",
                                  random_state=rng))
    bc = rng.standard_normal(40)
    x0 = rng.standard_normal(120)
    Cj, Ct = pair(C_sp)
    out_j = jlinalg.lsqr(Cj, bc, x0=x0, atol=1e-10, btol=1e-10)
    out_t = tlinalg.lsqr(Ct, torch.from_numpy(bc), x0=x0, atol=1e-10,
                         btol=1e-10)
    assert out_t[1:3] == (out_j[1], int(out_j[2]))
    assert_close(out_t[0], out_j[0], 1e-9)
    zero = tlinalg.lsqr(Ct, torch.zeros(40, dtype=torch.float64))
    assert zero[1:3] == (0, 0) and not zero[0].any()


@pytest.mark.parametrize("damp", [0.0, 0.7])
def test_lsmr_overdetermined(damp):
    B_sp, b = tall()
    Bj, Bt = pair(B_sp)
    out_j = jlinalg.lsmr(Bj, b, damp=damp, atol=1e-8, btol=1e-8,
                         maxiter=2000)
    out_t = tlinalg.lsmr(Bt, torch.from_numpy(b), damp=damp, atol=1e-8,
                         btol=1e-8, maxiter=2000)
    assert out_t[1:3] == (out_j[1], int(out_j[2]))
    assert_close(out_t[0], out_j[0], 1e-9)
    # normr, normar, norma, conda, normx
    assert_estimates(out_t[3:], out_j[3:], small=[1, 3])
    ref = ssl.lsmr(B_sp, b, damp=damp, atol=1e-8, btol=1e-8,
                   maxiter=2000)
    assert out_t[1] == ref[1]
    assert_close(out_t[0], ref[0], 1e-6)


def test_lsmr_istop_cases():
    rng = np.random.default_rng(1)
    B_sp, _ = tall(200, 80, seed=1)
    Bj, Bt = pair(B_sp)
    xs = rng.standard_normal(80)
    b = B_sp @ xs
    for kw in (dict(atol=1e-10, btol=1e-10, maxiter=2000),   # istop 1
               dict(atol=0, btol=0, maxiter=2000, conv_test_iters=1)):
        out_j = jlinalg.lsmr(Bj, b, **kw)
        out_t = tlinalg.lsmr(Bt, torch.from_numpy(b), **kw)
        assert out_t[1:3] == (out_j[1], int(out_j[2]))
        assert_close(out_t[0], out_j[0], 1e-9)
    # The condition limit: istop 3, as scipy.
    d = np.concatenate([np.ones(50), np.full(10, 1e-9)])
    I_sp = sp.csr_array(sp.diags([d], [0], format="csr"))
    bi = rng.standard_normal(60)
    out = tlinalg.lsmr(tsparse.csr_array(I_sp, device="cpu"),
                       torch.from_numpy(bi), conlim=1e8, atol=0, btol=0,
                       maxiter=500, conv_test_iters=1)
    ref = ssl.lsmr(I_sp, bi, conlim=1e8, atol=0, btol=0, maxiter=500)
    assert out[1] == ref[1] == 3
    zero = tlinalg.lsmr(Bt, torch.zeros(200, dtype=torch.float64))
    assert zero[1:3] == (0, 0) and not zero[0].any()


def test_lsqr_lsmr_float32():
    B_sp, b = tall()
    B_sp = sp.csr_array(B_sp.astype(np.float32))
    b = b.astype(np.float32)
    Bj, Bt = pair(B_sp)
    for solve_j, solve_t in ((jlinalg.lsqr, tlinalg.lsqr),
                             (jlinalg.lsmr, tlinalg.lsmr)):
        out_j = solve_j(Bj, b, atol=1e-5, btol=1e-5)
        out_t = solve_t(Bt, torch.from_numpy(b), atol=1e-5, btol=1e-5)
        assert out_t[0].dtype == torch.float32
        assert abs(out_t[2] - int(out_j[2])) <= 10
        xj = np.asarray(out_j[0])
        assert np.linalg.norm(out_t[0].numpy() - xj) <= \
            1e-3 * np.linalg.norm(xj)


def test_lsqr_show_falls_back_to_scipy(capsys):
    B_sp, b = tall()
    _, Bt = pair(B_sp)
    out = tlinalg.lsqr(Bt, torch.from_numpy(b), show=True, atol=1e-10,
                       btol=1e-10)
    ref = ssl.lsqr(B_sp, b, atol=1e-10, btol=1e-10)
    assert isinstance(out[0], torch.Tensor) and out[1] == ref[1]
    assert_close(out[0], ref[0], 1e-12)


# ---------------------------------------------------- differentiable_solve


@pytest.mark.parametrize("method", ["cg", "minres"])
def test_differentiable_solve_grad_matches_jax(method):
    A_sp = poisson()
    Aj, At = pair(A_sp)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A_sp.shape[0])
    w = rng.standard_normal(A_sp.shape[0])
    gj = jax.grad(lambda bb: jnp.vdot(
        jnp.asarray(w), jlinalg.differentiable_solve(Aj, bb,
                                                     method=method)))(
        jnp.asarray(b))
    bt = torch.from_numpy(b).requires_grad_()
    xt = tlinalg.differentiable_solve(At, bt, method=method)
    torch.dot(torch.from_numpy(w), xt).backward()
    assert_close(bt.grad, gj, 1e-9)
    assert_close(xt, jlinalg.differentiable_solve(Aj, b, method=method),
                 1e-9)
    np.testing.assert_allclose(bt.grad.numpy(),
                               np.linalg.solve(A_sp.toarray(), w),
                               rtol=1e-7, atol=1e-9)


def test_differentiable_solve_gradcheck_and_errors():
    A_sp = poisson(N=4)
    _, At = pair(A_sp)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(16))
    b.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda bb: tlinalg.differentiable_solve(At, bb, conv_test_iters=1),
        (b,))
    with pytest.raises(ValueError, match="supports 'cg'"):
        tlinalg.differentiable_solve(At, b, method="gmres")


def test_differentiable_solve_float32_default_tolerance():
    A_sp = poisson(dtype=np.float32)
    Aj, At = pair(A_sp)
    b = np.random.default_rng(2).standard_normal(A_sp.shape[0]).astype(
        np.float32)
    bt = torch.from_numpy(b).requires_grad_()
    x = tlinalg.differentiable_solve(At, bt)
    x.sum().backward()
    want = np.linalg.solve(A_sp.toarray().astype(np.float64),
                           np.ones(A_sp.shape[0]))
    assert np.linalg.norm(bt.grad.numpy() - want) <= \
        1e-4 * np.linalg.norm(want)
    xj = np.asarray(jlinalg.differentiable_solve(Aj, b))
    assert np.linalg.norm(x.detach().numpy() - xj) <= \
        1e-4 * np.linalg.norm(xj)
