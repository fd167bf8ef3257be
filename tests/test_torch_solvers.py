# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``gmres``, ``bicgstab``, ``cg_axpby``, sparse ``rmatvec``
and ``norm`` against the JAX package's, on the CPU (``refine=``:
``test_torch_compressed.py``).

Mirrors ``test_gmres_solve.py``, ``test_gmres_syncfree.py``,
``test_bicgstab.py`` and ``test_cg_axpby.py``.  The operators are built
by scipy from a seed and handed to both packages: a nonsymmetric
upwinded convection-diffusion operator on a 10x10 grid (100 unknowns,
-1.5 below and -0.5 above the diagonal, GMRES takes several restart
cycles on it), a complex shift of it, and a block-clustered matrix for
the norms.

Tolerances.  In float64 and complex128 the iteration counts are equal
and the solutions agree at rtol 1e-9: both run the same arithmetic and
differ only in the order XLA and PyTorch sum a dot product, which the
solve amplifies by the operator's condition number (about 60 here).  In
float32 the counts may differ by one convergence test (a restart cycle
for GMRES, 25 iterations for BiCGSTAB) and the solutions agree at 1e-3
of their norm: both stop on a rounded residual estimate at rtol 1e-5,
and their iterates drift apart by about the stopping tolerance times
the condition number.  Norms agree at 1e-12 relative (float64 sums in
another order); ``norm`` along an axis of a float64 matrix sums each
row or column in the stored order in both packages.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse
import legate_sparse_tpu.linalg as jlinalg

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch import runtime

GRID = 10


@pytest.fixture(autouse=True)
def _cpu():
    runtime.set_device("cpu")
    yield
    runtime.set_device(None)


def convdiff(grid=GRID, dtype=np.float64):
    """Upwinded convection-diffusion: 4 on the diagonal, -1.5 on -1,
    -0.5 on +1 (no coupling across a grid row's end), -1 on +-grid."""
    n = grid * grid
    lo = np.full(n - 1, -1.5)
    up = np.full(n - 1, -0.5)
    lo[np.arange(1, grid) * grid - 1] = 0.0
    up[np.arange(1, grid) * grid - 1] = 0.0
    far = np.full(n - grid, -1.0)
    A = sp.diags([np.full(n, 4.0), lo, up, far, far],
                 [0, -1, 1, grid, -grid], format="csr")
    return sp.csr_array(A.astype(dtype))


def pair(A_sp):
    return jsparse.csr_array(A_sp), tsparse.csr_array(A_sp, device="cpu")


def rhs(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n)
    if np.dtype(dtype).kind == "c":
        b = b + 1j * rng.standard_normal(n)
    return b.astype(dtype)


def assert_close(xt, xj, rtol):
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=rtol,
                               atol=rtol * float(np.abs(xj).max()))


# ---------------------------------------------------------------- gmres


@pytest.mark.parametrize("dtype,restart", [
    (np.float64, 7), (np.float64, 40), (np.complex128, 7)])
def test_gmres_iterations_equal(dtype, restart):
    A_sp = convdiff()
    if np.dtype(dtype).kind == "c":
        A_sp = sp.csr_array(A_sp + 0.5j * sp.eye(A_sp.shape[0]))
    Aj, At = pair(A_sp)
    b = rhs(A_sp.shape[0], dtype)
    xj, itj = jlinalg.gmres(Aj, b, rtol=1e-10, restart=restart,
                            maxiter=2000)
    xt, itt = tlinalg.gmres(At, torch.from_numpy(b), rtol=1e-10,
                            restart=restart, maxiter=2000)
    assert itt == int(itj) and itt >= restart
    assert xt.dtype == torch.from_numpy(b).dtype
    assert_close(xt, xj, 1e-9)
    res = np.linalg.norm(A_sp @ xt.numpy() - b) / np.linalg.norm(b)
    assert res < 1e-9


def test_gmres_float32():
    A_sp = convdiff(dtype=np.float32)
    Aj, At = pair(A_sp)
    b = rhs(A_sp.shape[0], np.float32)
    xj, itj = jlinalg.gmres(Aj, b, rtol=1e-5, restart=7, maxiter=2000)
    xt, itt = tlinalg.gmres(At, torch.from_numpy(b), rtol=1e-5, restart=7,
                            maxiter=2000)
    assert At.spmv_path == "dia-kernel"
    assert xt.dtype == torch.float32
    assert abs(itt - int(itj)) <= 7
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-3 * np.linalg.norm(xj)


def test_gmres_restrt_alias_and_preconditioner():
    A_sp = convdiff()
    Aj, At = pair(A_sp)
    b = rhs(A_sp.shape[0])
    xa, ita = tlinalg.gmres(At, torch.from_numpy(b), rtol=1e-10, restrt=5)
    xb, itb = tlinalg.gmres(At, torch.from_numpy(b), rtol=1e-10, restart=5)
    assert ita == itb and torch.equal(xa, xb)
    with pytest.raises(ValueError):
        tlinalg.gmres(At, torch.from_numpy(b), restart=5, restrt=5)
    # Right preconditioning with the diagonal's inverse, both packages.
    dinv = 1.0 / A_sp.diagonal()
    Mj = jlinalg.LinearOperator(A_sp.shape, matvec=lambda v: dinv * v,
                                dtype=np.float64)
    dinv_t = torch.from_numpy(dinv)
    Mt = tlinalg.LinearOperator(A_sp.shape, matvec=lambda v: dinv_t * v,
                                dtype=torch.float64)
    xj, itj = jlinalg.gmres(Aj, b, M=Mj, rtol=1e-10, restart=8)
    xt, itt = tlinalg.gmres(At, torch.from_numpy(b), M=Mt, rtol=1e-10,
                            restart=8)
    assert itt == int(itj)
    assert_close(xt, xj, 1e-9)


@pytest.mark.parametrize("callback_type", [None, "pr_norm"])
def test_gmres_callbacks(callback_type):
    A_sp = convdiff()
    Aj, At = pair(A_sp)
    b = rhs(A_sp.shape[0])
    seen_j, seen_t = [], []
    xj, itj = jlinalg.gmres(Aj, b, rtol=1e-10, restart=6,
                            callback=seen_j.append,
                            callback_type=callback_type)
    xt, itt = tlinalg.gmres(At, torch.from_numpy(b), rtol=1e-10, restart=6,
                            callback=seen_t.append,
                            callback_type=callback_type)
    assert itt == int(itj) == 6 * len(seen_t) == 6 * len(seen_j)
    if callback_type == "pr_norm":
        # Relative residuals down to 1e-11: each is held at 1e-9 of
        # itself or 1e-14 absolute (the float64 rounding of b - A x,
        # relative to |b|).
        np.testing.assert_allclose(seen_t, seen_j, rtol=1e-9, atol=1e-14)
        assert all(isinstance(v, float) for v in seen_t)
    else:
        for t, j in zip(seen_t, seen_j):
            assert_close(t, j, 1e-9)
        assert torch.equal(seen_t[-1], xt)


def test_gmres_happy_breakdown():
    """b in a two-dimensional Krylov space (A = I + rank 1): the
    Arnoldi breaks down mid-cycle, R has zero columns after it, and the
    guarded back-substitution still gives the solution."""
    n = 50
    rng = np.random.default_rng(3)
    u = rng.standard_normal(n)
    A_d = np.eye(n) + np.outer(u, u) / n
    b = rng.standard_normal(n)
    A_sp = sp.csr_array(A_d)
    Aj, At = pair(A_sp)
    xj, itj = jlinalg.gmres(Aj, b, rtol=1e-12, restart=30, maxiter=600)
    xt, itt = tlinalg.gmres(At, torch.from_numpy(b), rtol=1e-12,
                            restart=30, maxiter=600)
    assert itt == int(itj) == 30
    np.testing.assert_allclose(A_d @ xt.numpy(), b, atol=1e-9)
    assert_close(xt, xj, 1e-9)


def test_gmres_exact_start_keeps_x0():
    A_sp = convdiff()
    Aj, At = pair(A_sp)
    x_true = rhs(A_sp.shape[0], seed=5)
    b = A_sp @ x_true
    xt, itt = tlinalg.gmres(At, torch.from_numpy(b), x0=x_true, rtol=1e-8,
                            restart=10, maxiter=100)
    xj, itj = jlinalg.gmres(Aj, b, x0=x_true, rtol=1e-8, restart=10,
                            maxiter=100)
    assert itt == int(itj) == 0
    assert torch.equal(xt, torch.from_numpy(x_true))


def _counting_fetch(monkeypatch):
    fetched = []
    real = tlinalg._host_fetch

    def counted(t):
        fetched.append(t.numel())
        return real(t)

    monkeypatch.setattr(tlinalg, "_host_fetch", counted)
    return fetched


def test_gmres_one_host_fetch_per_cycle(monkeypatch):
    """rtol = atol = 0 never converges: ``cycles`` cycles fetch
    ``[beta, resid]`` once each and nothing else.  A solve that
    converges adds one fetch of the true residual's norm for each
    suspected convergence."""
    A_sp = convdiff(dtype=np.float32)
    _, At = pair(A_sp)
    b = torch.ones(A_sp.shape[0], dtype=torch.float32)
    fetched = _counting_fetch(monkeypatch)
    restart, cycles = 8, 5
    _, iters = tlinalg.gmres(At, b, rtol=0.0, atol=0.0, restart=restart,
                             maxiter=cycles * restart)
    assert iters == cycles * restart
    assert fetched == [2] * cycles
    fetched.clear()
    _, iters = tlinalg.gmres(At, b, rtol=1e-5, restart=restart)
    assert fetched.count(2) == iters // restart
    assert fetched[-1] == 1 and fetched.count(1) >= 1


def test_gmres_cycle_makes_no_host_fetch(monkeypatch):
    """The cycle itself never reaches ``_host_fetch``, nor ``.item()``,
    ``float()``, ``bool()`` or ``tolist()`` of a tensor, each of which
    would wait for the device there."""
    A_sp = convdiff()
    _, At = pair(A_sp)
    fetched = _counting_fetch(monkeypatch)
    b = torch.from_numpy(rhs(A_sp.shape[0]))
    x = torch.zeros_like(b)
    op = tlinalg.make_linear_operator(At)
    op.matvec(b)            # the structure caches build on the first call
    for name in ("item", "__float__", "__bool__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, _forbidden_sync)
    x_new, stats = tlinalg._gmres_cycle(op.matvec, lambda v: v, x, b, 9)
    monkeypatch.undo()
    assert fetched == []
    assert stats.shape == (2,) and x_new.shape == b.shape


def _forbidden_sync(self, *args):
    raise AssertionError("a host sync inside the GMRES cycle")


def test_refine_raises_until_compressed_storage():
    """Compressed storage is ported, so ``refine=`` runs (its
    differentials are in ``test_torch_compressed.py``); what still
    raises is a cycle count that is not positive."""
    A_sp = convdiff()
    _, At = pair(A_sp)
    b = torch.ones(A_sp.shape[0], dtype=torch.float64)
    for solve in (tlinalg.cg, tlinalg.gmres):
        with pytest.raises(ValueError, match="positive cycle count"):
            solve(At, b, refine=0)
    x, _ = tlinalg.gmres(At, b, rtol=1e-8, refine="auto")
    assert (float(torch.linalg.vector_norm(b - At @ x))
            <= 1.05e-8 * float(torch.linalg.vector_norm(b)))


# ------------------------------------------------------------- bicgstab


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_bicgstab_iterations_equal(dtype):
    A_sp = convdiff()
    if np.dtype(dtype).kind == "c":
        A_sp = sp.csr_array(A_sp + 0.5j * sp.eye(A_sp.shape[0]))
    Aj, At = pair(A_sp)
    b = rhs(A_sp.shape[0], dtype)
    xj, itj = jlinalg.bicgstab(Aj, b, rtol=1e-10, maxiter=500)
    xt, itt = tlinalg.bicgstab(At, torch.from_numpy(b), rtol=1e-10,
                               maxiter=500)
    assert itt == int(itj) and itt % 25 == 0
    assert_close(xt, xj, 1e-9)


def test_bicgstab_float32_and_preconditioned():
    A_sp = convdiff(dtype=np.float32)
    Aj, At = pair(A_sp)
    b = rhs(A_sp.shape[0], np.float32)
    xj, itj = jlinalg.bicgstab(Aj, b, rtol=1e-5)
    xt, itt = tlinalg.bicgstab(At, torch.from_numpy(b), rtol=1e-5)
    assert abs(itt - int(itj)) <= 25
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-3 * np.linalg.norm(xj)
    dinv = (1.0 / A_sp.diagonal()).astype(np.float32)
    Mj = jlinalg.LinearOperator(A_sp.shape, matvec=lambda v: dinv * v,
                                dtype=np.float32)
    dinv_t = torch.from_numpy(dinv)
    Mt = tlinalg.LinearOperator(A_sp.shape, matvec=lambda v: dinv_t * v,
                                dtype=torch.float32)
    xj, itj = jlinalg.bicgstab(Aj, b, rtol=1e-5, M=Mj)
    xt, itt = tlinalg.bicgstab(At, torch.from_numpy(b), rtol=1e-5, M=Mt)
    assert abs(itt - int(itj)) <= 25
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= \
        1e-3 * np.linalg.norm(np.asarray(xj))


def test_bicgstab_callback_path():
    """With a callback the test runs every iteration, as the JAX
    package's callback path does: the same count, every iterate seen,
    the same solution as ``conv_test_iters=1``."""
    A_sp = convdiff()
    Aj, At = pair(A_sp)
    b = rhs(A_sp.shape[0])
    seen_j, seen_t = [], []
    xj, itj = jlinalg.bicgstab(Aj, b, rtol=1e-8, maxiter=500,
                               callback=seen_j.append)
    xt, itt = tlinalg.bicgstab(At, torch.from_numpy(b), rtol=1e-8,
                               maxiter=500, callback=seen_t.append)
    assert itt == int(itj) == len(seen_t) == len(seen_j)
    for k in (0, itt // 2, itt - 1):
        assert_close(seen_t[k], seen_j[k], 1e-9)
    x1, it1 = tlinalg.bicgstab(At, torch.from_numpy(b), rtol=1e-8,
                               maxiter=500, conv_test_iters=1)
    assert it1 == itt and torch.equal(x1, xt)


def test_bicgstab_exact_start_no_nan():
    A_sp = sp.csr_array(sp.diags([np.full(50, 2.0)], [0], format="csr"))
    _, At = pair(A_sp)
    b = np.ones(50)
    xt, _ = tlinalg.bicgstab(At, torch.from_numpy(b), x0=b / 2.0,
                             rtol=1e-12, maxiter=100)
    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(xt.numpy(), b / 2.0, atol=1e-12)


# ----------------------------------------------------- cg_axpby, rmatvec


@pytest.mark.parametrize("isalpha", [True, False])
@pytest.mark.parametrize("negate", [True, False])
def test_cg_axpby(isalpha, negate):
    rng = np.random.default_rng(3)
    y = rng.standard_normal(57)
    x = rng.standard_normal(57)
    want = np.asarray(jlinalg.cg_axpby(y.copy(), x, 3.7, 1.3,
                                       isalpha=isalpha, negate=negate))
    y_arg = y.copy()
    out = tlinalg.cg_axpby(y_arg, x, 3.7, 1.3, isalpha=isalpha,
                           negate=negate)
    assert out is y_arg                       # numpy y: updated in place
    np.testing.assert_array_equal(y_arg, want)
    yt = torch.from_numpy(y.copy())
    res = tlinalg.cg_axpby(yt, torch.from_numpy(x), 3.7, 1.3,
                           isalpha=isalpha, negate=negate)
    assert torch.equal(yt, torch.from_numpy(y))  # a tensor y: a new result
    np.testing.assert_array_equal(res.numpy(), want)


def test_cg_axpby_float32_scalars():
    y = np.arange(5, dtype=np.float32)
    x = np.ones(5, dtype=np.float32)
    a, b = np.float32(2.5), np.float32(0.5)
    want = np.asarray(jlinalg.cg_axpby(y.copy(), x, a, b))
    res = tlinalg.cg_axpby(torch.from_numpy(y), torch.from_numpy(x),
                           torch.tensor(a), torch.tensor(b))
    assert res.dtype == torch.float32
    np.testing.assert_array_equal(res.numpy(), want)


def test_sparse_rmatvec_is_the_cached_conjugate_transpose():
    rng = np.random.default_rng(4)
    A_sp = sp.random(30, 20, density=0.3, format="csr", random_state=rng)
    A_sp = sp.csr_array(A_sp + 1j * sp.random(30, 20, density=0.3,
                                               format="csr",
                                               random_state=rng))
    Aj, At = pair(A_sp)
    x = rng.standard_normal(30) + 1j * rng.standard_normal(30)
    op_t = tlinalg.make_linear_operator(At)
    op_j = jlinalg.make_linear_operator(Aj)
    yt = op_t.rmatvec(torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(op_j.rmatvec(x)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yt.numpy(), A_sp.conj().T @ x, rtol=1e-12,
                               atol=1e-12)
    cached = op_t.AT
    op_t.rmatvec(torch.from_numpy(x))
    assert op_t.AT is cached and cached.shape == (20, 30)


# ----------------------------------------------------------------- norm


def _norm_matrix(dtype):
    """Block-clustered, an empty row and column, a stored zero, and
    negative values: every norm's implicit-zero case shows."""
    rng = np.random.default_rng(7)
    A = sp.random(24, 18, density=0.3, format="lil", random_state=rng)
    A[3, :] = 0
    A[:, 5] = 0
    A = sp.csr_array(A)
    A.data = A.data - 0.5
    A.data[0] = 0.0
    if np.dtype(dtype).kind == "c":
        A = sp.csr_array(A + 0.3j * A)
    return sp.csr_array(A.astype(dtype))


MATRIX_ORDS = [None, "fro", 1, -1, np.inf, -np.inf, 2]
VECTOR_ORDS = [None, 2, 1, np.inf, -np.inf, 0]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_norm_matrix_orders(dtype):
    A_sp = _norm_matrix(dtype)
    Aj, At = pair(A_sp)
    for ord in MATRIX_ORDS:
        got = tlinalg.norm(At, ord=ord)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, jlinalg.norm(Aj, ord=ord),
                                   rtol=1e-12)
        np.testing.assert_allclose(got, sp.linalg.norm(A_sp, ord=ord),
                                   rtol=1e-12)


@pytest.mark.parametrize("axis", [0, 1, -1, -2])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_norm_vector_orders(axis, dtype):
    A_sp = _norm_matrix(dtype)
    Aj, At = pair(A_sp)
    for ord in VECTOR_ORDS:
        got = tlinalg.norm(At, ord=ord, axis=axis)
        want = np.asarray(jlinalg.norm(Aj, ord=ord, axis=axis))
        assert isinstance(got, torch.Tensor) and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
        if ord != 0 and np.dtype(dtype).kind == "f":
            np.testing.assert_allclose(
                got.numpy(), sp.linalg.norm(A_sp, ord=ord, axis=axis),
                rtol=1e-12)


def test_norm_float32_duplicates_and_errors():
    rows = np.array([0, 0, 1, 2, 2])
    cols = np.array([1, 1, 0, 2, 0])
    vals = np.array([1.0, 2.0, -4.0, 0.5, 3.0], dtype=np.float32)
    A_sp = sp.csr_array((vals, (rows, cols)), shape=(3, 3))
    Aj = jsparse.csr_array((vals, (rows, cols)), shape=(3, 3))
    At = tsparse.csr_array((vals, (rows, cols)), shape=(3, 3), device="cpu")
    for ord in MATRIX_ORDS:
        assert tlinalg.norm(At, ord=ord) == pytest.approx(
            float(jlinalg.norm(Aj, ord=ord)), rel=1e-6)
    for ord in VECTOR_ORDS:
        np.testing.assert_allclose(
            tlinalg.norm(At, ord=ord, axis=0).numpy(),
            np.asarray(jlinalg.norm(Aj, ord=ord, axis=0)), rtol=1e-6)
    assert tlinalg.norm(At, axis=1).dtype == torch.float32
    with pytest.raises(TypeError):
        tlinalg.norm(torch.ones(3, 3))
    with pytest.raises(ValueError):
        tlinalg.norm(At, ord="nuc")
    with pytest.raises(ValueError):
        tlinalg.norm(At, ord=3, axis=0)
    with pytest.raises(ValueError):
        tlinalg.norm(At, axis=2)
    np.testing.assert_allclose(tlinalg.norm(At), np.linalg.norm(
        A_sp.toarray()), rtol=1e-6)
