# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's CG against the JAX package's, on the ``examples/pde.py``
operator.

The 2-D Dirichlet Laplacian of a 34x34 grid (1024 unknowns) is built by
the JAX package, carried across with ``interop`` and solved by both
``cg``s from the same right-hand side.  In f64 the iteration counts are
equal and the solutions agree at rtol 1e-9 (the two sum the dot
products in another order, and CG amplifies that by the operator's
condition number, about 5e2 here).  In f32 the counts may differ by one
convergence check (25 iterations) and the solutions agree at rtol 2e-3:
both stop on their recursive residual at rtol 1e-4, and the f32 rounding
of the operator's 1e3-sized entries makes the two iterates drift apart
by about the stopping tolerance times the condition number.
"""

import numpy as np
import pytest
import torch

import legate_sparse_tpu as jsparse
import legate_sparse_tpu.linalg as jlinalg

from legate_sparse_tpu_torch import interop
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch.apps import pde as tpde

NX = NY = 34


def _jax_operator(dtype):
    dx, dy = tpde.grid_spacing(NX, NY)
    a, g = 1.0 / dx**2, 1.0 / dy**2
    c = -2.0 * a - 2.0 * g
    diag_a = np.full((NX - 2) * (NY - 2) - 1, a)
    diag_a[NX - 3::NX - 2] = 0.0
    diag_g = g * np.ones((NX - 2) * (NY - 3))
    diag_c = c * np.ones((NX - 2) * (NY - 2))
    return jsparse.diags([diag_g, diag_a, diag_c, diag_a, diag_g],
                         [-(NX - 2), -1, 0, 1, NX - 2], dtype=dtype).tocsr()


def _rhs(dtype=np.float64):
    # The manufactured right-hand side is a sum of two eigenvectors of
    # the discrete operator, so CG meets it in two steps; a random one
    # takes CG through a long solve.
    n = (NX - 2) * (NY - 2)
    return np.random.default_rng(0).standard_normal(n).astype(dtype)


def _port(Aj):
    return interop.csr_from_parts(np.asarray(Aj.data), np.asarray(Aj.indices),
                                  np.asarray(Aj.indptr), Aj.shape,
                                  device="cpu")


def test_operator_matches_pde_app():
    """The app's operator is the example's: bitwise-equal CSR."""
    Aj = _jax_operator(np.float64)
    dx, dy = tpde.grid_spacing(NX, NY)
    At = tpde.d2_mat_dirichlet_2d(NX, NY, dx, dy, dtype=torch.float64,
                                  device="cpu")
    d, i, p = interop.to_numpy_parts(At)
    np.testing.assert_array_equal(d, np.asarray(Aj.data))
    np.testing.assert_array_equal(i, np.asarray(Aj.indices))
    np.testing.assert_array_equal(p, np.asarray(Aj.indptr))


@pytest.mark.parametrize("rtol", [1e-6, 1e-10])
def test_cg_f64_iterations_equal(rtol):
    Aj = _jax_operator(np.float64)
    At = _port(Aj)
    b = _rhs()
    xj, itj = jlinalg.cg(Aj, b, rtol=rtol, maxiter=2000)
    xt, itt = tlinalg.cg(At, torch.from_numpy(b), rtol=rtol, maxiter=2000)
    assert At.spmv_path == "dia-torch"
    assert int(itj) == itt
    assert 50 < itt < 2000
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9,
                               atol=1e-9 * float(np.abs(np.asarray(xj)).max()))


def test_cg_f64_maxiter_bound():
    """A budget that ends before convergence: both stop at maxiter."""
    Aj = _jax_operator(np.float64)
    b = _rhs()
    xj, itj = jlinalg.cg(Aj, b, rtol=1e-12, maxiter=30)
    xt, itt = tlinalg.cg(_port(Aj), torch.from_numpy(b), rtol=1e-12,
                         maxiter=30)
    assert int(itj) == itt == 30
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9,
                               atol=1e-9 * float(np.abs(np.asarray(xj)).max()))


def test_cg_f32():
    Aj = _jax_operator(np.float32)
    At = _port(Aj)
    b = _rhs(np.float32)
    xj, itj = jlinalg.cg(Aj, b, rtol=1e-4, maxiter=2000)
    xt, itt = tlinalg.cg(At, torch.from_numpy(b), rtol=1e-4, maxiter=2000)
    assert At.spmv_path == "dia-kernel"
    assert xt.dtype == torch.float32
    assert abs(int(itj) - itt) <= 25
    xj = np.asarray(xj)
    assert (np.linalg.norm(xt.numpy() - xj)
            <= 2e-3 * np.linalg.norm(xj))


def test_cg_callback_sees_every_iterate():
    Aj = _jax_operator(np.float64)
    At = _port(Aj)
    b = _rhs()
    seen_j, seen_t = [], []
    xj, itj = jlinalg.cg(Aj, b, rtol=1e-8, maxiter=2000,
                         callback=lambda x: seen_j.append(np.asarray(x)))
    xt, itt = tlinalg.cg(At, torch.from_numpy(b), rtol=1e-8, maxiter=2000,
                         callback=lambda x: seen_t.append(x.clone()))
    assert int(itj) == itt == len(seen_t) == len(seen_j)
    scale = float(np.abs(seen_j[-1]).max())
    for k in (0, itt // 2, itt - 1):
        np.testing.assert_allclose(seen_t[k].numpy(), seen_j[k], rtol=1e-9,
                                   atol=1e-9 * scale)
    assert torch.equal(seen_t[-1], xt)


def test_cg_exact_start_no_nan():
    """x0 already the solution: the safe divides keep x finite."""
    Aj = _jax_operator(np.float64)
    At = _port(Aj)
    x_true = np.random.default_rng(0).standard_normal(At.shape[0])
    b = np.array(Aj @ x_true)
    xt, itt = tlinalg.cg(At, torch.from_numpy(b), x0=x_true, rtol=1e-8)
    xj, itj = jlinalg.cg(Aj, b, x0=x_true, rtol=1e-8)
    assert int(itj) == itt
    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(xt.numpy(), x_true, rtol=1e-8, atol=1e-8)


def test_pde_app_solves_on_cpu():
    out = tpde.solve(NX, NY, tol=1e-10, dtype=torch.float64, device="cpu")
    assert out["path"] == "dia-torch"
    assert out["rel_residual"] <= 1e-9
    # The discrete solution is within the discretisation error of the
    # exact one, ``examples/pde.py::p_exact_2d``.
    err = tpde.relative_error_to_exact(NX, NY, out["x"])
    assert err <= 1e-2


def test_linear_operators():
    Aj = _jax_operator(np.float64)
    At = _port(Aj)
    op = tlinalg.make_linear_operator(At)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        At.shape[1]))
    np.testing.assert_allclose(op.matvec(x).numpy(),
                               np.asarray(Aj @ x.numpy()), rtol=1e-12,
                               atol=1e-12)
    ident = tlinalg.IdentityOperator(At.shape, dtype=torch.float64)
    assert torch.equal(ident.matvec(x), x)
    custom = tlinalg.LinearOperator(At.shape, matvec=lambda v: 2.0 * v,
                                    dtype=torch.float64)
    assert torch.equal(custom @ x, 2.0 * x)
    x_cg, it = tlinalg.cg(custom, x, rtol=1e-12)
    torch.testing.assert_close(x_cg, x / 2.0, rtol=1e-12, atol=1e-12)
    assert tlinalg._get_atol_rtol(2.0, tol=1e-3) == \
        jlinalg._get_atol_rtol(2.0, tol=1e-3)
    assert tlinalg._get_atol_rtol(2.0, atol=None, rtol=1e-2) == \
        jlinalg._get_atol_rtol(2.0, atol=None, rtol=1e-2)
