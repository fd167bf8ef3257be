# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``jacobi``, ``block_jacobi`` and ``expm_multiply`` against
the JAX package's, on the CPU.

Mirrors ``test_precond.py`` and ``test_expm.py``.  The same scipy
matrices go to both packages: random sparse matrices made diagonally
dominant (a ragged last block among them), the anisotropic 2-D Poisson
operator on a 16x16 grid for the preconditioned solves, and shifted
random matrices for the exponential.

Tolerances.  A preconditioner's apply agrees at 1e-12 relative: the
blocks are inverted by LAPACK's LU in both packages, whose last digits
may differ.  Preconditioned CG in float64 takes the same number of
iterations and agrees at rtol 1e-9.  ``expm_multiply`` agrees at 1e-12
in float64 (the same Taylor chain in the same order; only the sums of
the SpMV/SpMM and ``exp`` round differently) and at 1e-5 in float32
(the same chain, rounded in float32 over ``s * m`` terms, about 100
here).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as ssl
import torch

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


def dominant(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.4, format="csr", random_state=rng) \
        + 5 * sp.eye(n)
    if np.dtype(dtype).kind == "c":
        A = A + 1j * sp.random(n, n, density=0.3, format="csr",
                               random_state=rng)
    return sp.csr_array(A.astype(dtype)), rng


def poisson(N=16, eps=0.05):
    n = N * N
    off1 = np.full(n - 1, -1.0)
    off1[np.arange(1, N) * N - 1] = 0.0
    offn = np.full(n - N, -eps)
    A = sp.diags([np.full(n, 2.0 + 2.0 * eps), off1, off1, offn, offn],
                 [0, 1, -1, N, -N], format="csr")
    return sp.csr_array(A)


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# -------------------------------------------------------------- precond


@pytest.mark.parametrize("n,bs,dtype", [(24, 8, np.float64),
                                        (20, 8, np.float64),
                                        (20, 7, np.complex128)])
def test_block_jacobi_apply(n, bs, dtype):
    A_sp, rng = dominant(n, dtype=dtype)
    Aj, At = pair(A_sp)
    Mj = jlinalg.block_jacobi(Aj, block_size=bs)
    Mt = tlinalg.block_jacobi(At, block_size=bs)
    v = rng.standard_normal(n).astype(dtype)
    close(Mt.matvec(torch.from_numpy(v)), Mj.matvec(v), 1e-12)
    close(Mt.rmatvec(torch.from_numpy(v)), Mj.rmatvec(v), 1e-12)
    D = A_sp.toarray()
    want = np.concatenate([np.linalg.solve(D[lo:lo + bs, lo:lo + bs],
                                           v[lo:lo + bs])
                           for lo in range(0, n, bs)])
    close(Mt.matvec(torch.from_numpy(v)), want, 1e-12)
    assert Mt.dtype == At.dtype
    # A scipy operand goes through the same path.
    close(tlinalg.block_jacobi(A_sp, block_size=bs).matvec(
        torch.from_numpy(v)), want, 1e-12)


def test_block_jacobi_keeps_duplicates_and_bs1_is_jacobi():
    rows = np.array([0, 0, 1, 2, 3, 3, 1])
    cols = np.array([0, 0, 1, 2, 3, 0, 0])
    vals = np.array([2.0, 1.0, 4.0, 5.0, 6.0, 1.0, 1.0])
    Aj = jsparse.csr_array((vals, (rows, cols)), shape=(4, 4))
    At = tsparse.csr_array((vals, (rows, cols)), shape=(4, 4),
                           device="cpu")
    v = np.arange(1.0, 5.0)
    for bs in (1, 2, 4):
        close(tlinalg.block_jacobi(At, bs).matvec(torch.from_numpy(v)),
              jlinalg.block_jacobi(Aj, bs).matvec(v), 1e-12)


def test_jacobi_apply_and_singular_rejection():
    A_sp, rng = dominant(20, seed=3)
    Aj, At = pair(A_sp)
    v = rng.standard_normal(20)
    Mt = tlinalg.jacobi(At)
    assert torch.equal(Mt.matvec(torch.from_numpy(v)),
                       torch.from_numpy(np.asarray(jlinalg.jacobi(Aj)
                                                   .matvec(v))))
    close(Mt.rmatvec(torch.from_numpy(v)), v / A_sp.diagonal(), 1e-15)
    with pytest.raises(ValueError, match="zero on the diagonal"):
        tlinalg.jacobi(tsparse.csr_array(np.array([[0.0, 1], [1, 0]]),
                                         device="cpu"))
    singular = tsparse.csr_array(np.array([[1.0, 1], [1, 1]]), device="cpu")
    with pytest.raises(ValueError, match="singular"):
        tlinalg.block_jacobi(singular, block_size=2)
    with pytest.raises(ValueError, match="square"):
        tlinalg.block_jacobi(tsparse.csr_array(np.ones((2, 3)),
                                               device="cpu"))


@pytest.mark.parametrize("which", ["jacobi", "block_jacobi"])
def test_preconditioned_cg_iterations_equal(which):
    A_sp = poisson()
    Aj, At = pair(A_sp)
    b = np.ones(A_sp.shape[0])
    make_j = getattr(jlinalg, which)
    make_t = getattr(tlinalg, which)
    args = () if which == "jacobi" else (16,)
    xj, itj = jlinalg.cg(Aj, b, M=make_j(Aj, *args), rtol=1e-10,
                         maxiter=4000, conv_test_iters=5)
    xt, itt = tlinalg.cg(At, torch.from_numpy(b), M=make_t(At, *args),
                         rtol=1e-10, maxiter=4000, conv_test_iters=5)
    assert itt == int(itj)
    close(xt, xj, 1e-9)
    if which == "block_jacobi":
        _, it_plain = tlinalg.cg(At, torch.from_numpy(b), rtol=1e-10,
                                 maxiter=4000, conv_test_iters=5)
        assert itt < 0.5 * it_plain


def test_block_jacobi_float32_with_minres():
    A_sp = sp.csr_array(poisson().astype(np.float32))
    Aj, At = pair(A_sp)
    b = np.ones(A_sp.shape[0], dtype=np.float32)
    Mt = tlinalg.block_jacobi(At, 16)
    v = np.random.default_rng(0).standard_normal(A_sp.shape[0]).astype(
        np.float32)
    close(Mt.matvec(torch.from_numpy(v)),
          jlinalg.block_jacobi(Aj, 16).matvec(v), 1e-6)
    x, _ = tlinalg.minres(At, torch.from_numpy(b), M=Mt, rtol=1e-5)
    assert x.dtype == torch.float32
    assert np.linalg.norm(A_sp @ x.numpy() - b) <= \
        2e-5 * np.linalg.norm(b)


# ---------------------------------------------------------- expm_multiply


def shifted(n, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.1, format="csr", random_state=rng) \
        - 0.5 * sp.eye(n)
    return sp.csr_array(A), rng


def test_expm_multiply_vector_and_block():
    A_sp, rng = shifted(60)
    Aj, At = pair(A_sp)
    b = rng.standard_normal(60)
    B = rng.standard_normal((60, 5))
    got = tlinalg.expm_multiply(At, torch.from_numpy(b))
    assert got.shape == (60,) and isinstance(got, torch.Tensor)
    close(got, jlinalg.expm_multiply(Aj, b), 1e-12)
    close(got, ssl.expm_multiply(A_sp, b), 1e-11)
    got = tlinalg.expm_multiply(At, torch.from_numpy(B))
    close(got, jlinalg.expm_multiply(Aj, B), 1e-12)
    assert At.spmm_path is not None


@pytest.mark.parametrize("endpoint", [None, False])
def test_expm_multiply_sweep(endpoint):
    A_sp, rng = shifted(40, seed=1)
    Aj, At = pair(A_sp)
    b = rng.standard_normal(40)
    kw = dict(start=0.0, stop=2.0, num=6, endpoint=endpoint)
    got = tlinalg.expm_multiply(At, torch.from_numpy(b), **kw)
    assert got.shape == (6, 40)
    close(got, jlinalg.expm_multiply(Aj, b, **kw), 1e-12)
    close(got, ssl.expm_multiply(A_sp, b, **kw), 1e-10)
    B = rng.standard_normal((40, 3))
    got = tlinalg.expm_multiply(At, torch.from_numpy(B), **kw)
    assert got.shape == (6, 40, 3)
    close(got, jlinalg.expm_multiply(Aj, B, **kw), 1e-12)


def test_expm_multiply_complex_float32_and_identity():
    A_sp, rng = shifted(40, seed=2)
    C_sp = sp.csr_array(A_sp + 1j * sp.random(40, 40, density=0.05,
                                              random_state=rng))
    Cj, Ct = pair(C_sp)
    b = rng.standard_normal(40).astype(np.complex128)
    close(tlinalg.expm_multiply(Ct, torch.from_numpy(b)),
          jlinalg.expm_multiply(Cj, b), 1e-12)
    A32 = sp.csr_array(A_sp.astype(np.float32))
    Aj, At = pair(A32)
    B = rng.standard_normal((40, 4)).astype(np.float32)
    got = tlinalg.expm_multiply(At, torch.from_numpy(B))
    assert got.dtype == torch.float32
    close(got, jlinalg.expm_multiply(Aj, B), 1e-5)
    # A = 2 I: the shifted product is 0 and eta gives e^2 exactly.
    I2 = tsparse.csr_array(sp.csr_array(2.0 * sp.eye(10)), device="cpu")
    close(tlinalg.expm_multiply(I2, torch.ones(10, dtype=torch.float64)),
          np.e ** 2 * np.ones(10), 1e-12)


def test_expm_multiply_dense_and_linear_operator():
    A_sp, rng = shifted(30, seed=3)
    A_d = A_sp.toarray()
    b = rng.standard_normal(30)
    close(tlinalg.expm_multiply(torch.from_numpy(A_d), torch.from_numpy(b)),
          jlinalg.expm_multiply(A_d, b), 1e-12)
    AT = torch.from_numpy(A_d.T.copy())
    Ad = torch.from_numpy(A_d)
    op = tlinalg.LinearOperator(A_sp.shape, matvec=lambda x: Ad @ x,
                                rmatvec=lambda x: AT @ x,
                                dtype=torch.float64)
    got = tlinalg.expm_multiply(op, torch.from_numpy(b))
    assert isinstance(got, torch.Tensor)
    close(got, ssl.expm_multiply(A_sp, b), 1e-9)
