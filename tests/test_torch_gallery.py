# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's gallery against the JAX package, and the facade slice end
to end.

Constructors and generators run in both packages on the same inputs and
seeds; the port runs on ``device="cpu"``.  Every constructor moves or
masks stored entries, so structure and values agree bit for bit;
``random``, ``powerlaw`` and ``rmat`` draw with numpy's ``Generator`` in
the same order, so their data, indices and indptr agree bit for bit.
The end-to-end test builds a 32x32-grid Poisson operator, rebuilds it
from ``tril + triu``, sets a diagonal and solves with CG in both
packages: products and the solution at rtol = atol = 1e-12 (f64) and
1e-5 (f32, CG's iterate).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse
import legate_sparse_tpu.linalg as jlinalg
from legate_sparse_tpu import gallery as jgallery

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.utils import to_numpy

from test_torch_coo_csc import same_coo
from test_torch_csr_ops import pair, rand_scipy, same_csr, same_dense


@pytest.fixture
def on_cpu():
    """The free functions that take scipy or dense operands build on the
    default device: the CPU here."""
    runtime.set_device("cpu")
    yield
    runtime.set_device(None)


def same_dia(Dj, Dt):
    assert type(Dt).__name__ == type(Dj).__name__ == "dia_array"
    assert Dt.offsets_tuple == tuple(int(o) for o in np.asarray(Dj.offsets))
    np.testing.assert_array_equal(to_numpy(Dt.data), np.asarray(Dj.data))
    assert str(Dt.dtype).replace("torch.", "") == np.dtype(Dj.dtype).name


@pytest.mark.parametrize("kw", [dict(m=5), dict(m=4, n=6, k=1),
                                dict(m=6, n=4, k=-2),
                                dict(m=5, dtype=np.float32, format="csr")])
def test_eye_identity(kw):
    Ej = jsparse.eye(**kw)
    Et = tsparse.eye(**kw, device="cpu")
    if kw.get("format") == "csr":
        same_csr(Ej, Et)
    else:
        same_dia(Ej, Et)
    same_dia(jsparse.identity(4), tsparse.identity(4, device="cpu"))
    for eye in (lambda: jsparse.eye(3, k=5),        # no diagonal left
                lambda: tsparse.eye(3, k=5, device="cpu")):
        with pytest.raises(ValueError):
            eye()


@pytest.mark.parametrize("k", [-2, 0, 3])
def test_tril_triu(k):
    Aj, At = pair(rand_scipy(12, 10, 0.4, 3))
    same_csr(jsparse.tril(Aj, k), tsparse.tril(At, k))
    same_csr(jsparse.triu(Aj, k), tsparse.triu(At, k))
    same_coo(jsparse.tril(Aj, k, format="coo"),
             tsparse.tril(At, k, format="coo"))
    S = rand_scipy(12, 10, 0.4, 3)
    np.testing.assert_array_equal(tsparse.triu(At, k).toscipy().toarray(),
                                  sp.triu(S, k).toarray())


def test_kron_and_kronsum():
    Aj, At = pair(rand_scipy(3, 4, 0.5, 1))
    Bj, Bt = pair(rand_scipy(2, 5, 0.5, 2, "float32"))
    same_csr(jsparse.kron(Aj, Bj), tsparse.kron(At, Bt))
    np.testing.assert_allclose(
        tsparse.kron(At, Bt).toscipy().toarray(),
        sp.kron(rand_scipy(3, 4, 0.5, 1),
                rand_scipy(2, 5, 0.5, 2, "float32")).toarray(), rtol=1e-7)
    same_coo(jsparse.kron(Aj, Bj, format="coo"),
             tsparse.kron(At, Bt, format="coo"))
    T1 = jsparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(4, 4))
    T2 = tsparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(4, 4),
                       device="cpu")
    U1 = jsparse.diags([1.0, 3.0], [0, 2], shape=(3, 3))
    U2 = tsparse.diags([1.0, 3.0], [0, 2], shape=(3, 3), device="cpu")
    same_csr(jsparse.kronsum(T1, U1), tsparse.kronsum(T2, U2))
    with pytest.raises(ValueError):
        tsparse.kronsum(At, U2)


def test_spdiags(on_cpu):
    data = np.array([[1, 2, 3, 4.0], [5, 6, 7, 8.0]])
    same_csr(jsparse.spdiags(data, [0, -1], 4, 4, format="csr"),
             tsparse.spdiags(data, [0, -1], 4, 4, format="csr"))
    same_dia(jsparse.spdiags(np.array([[1, 2, 3, 4]]), [0]),
             tsparse.spdiags(np.array([[1, 2, 3, 4]]), [0]))
    same_dia(jsparse.spdiags(data, [1, -2], (5, 6)),
             tsparse.spdiags(data, [1, -2], (5, 6)))


def test_stacking():
    Sa, Sb, Sc = (rand_scipy(5, 7, 0.4, 0), rand_scipy(3, 7, 0.5, 1,
                                                       "float32"),
                  rand_scipy(5, 3, 0.5, 2))
    (Aj, At), (Bj, Bt), (Cj, Ct) = pair(Sa), pair(Sb), pair(Sc)
    same_csr(jsparse.vstack([Aj, Bj]), tsparse.vstack([At, Bt]))
    same_csr(jsparse.hstack([Aj, Cj]), tsparse.hstack([At, Ct]))
    same_csr(jsparse.vstack([Aj, Bj], dtype=np.float32),
             tsparse.vstack([At, Bt], dtype=np.float32))
    same_csr(jsparse.block_diag([Aj, Bj, Cj]),
             tsparse.block_diag([At, Bt, Ct]))
    grid = [[Aj, Cj], [None, jsparse.eye(3, format="csr")]]
    tgrid = [[At, Ct], [None, tsparse.eye(3, format="csr", device="cpu")]]
    same_csr(jsparse.bmat(grid), tsparse.bmat(tgrid))
    same_csr(jsparse.block_array(grid, format="csr"),
             tsparse.block_array(tgrid, format="csr"))
    np.testing.assert_array_equal(
        tsparse.hstack([At, Ct]).toscipy().toarray(),
        sp.hstack([Sa, Sc]).toarray())
    for bad in (lambda: tsparse.vstack([At, Ct]),
                lambda: tsparse.hstack([At, Bt]),
                lambda: tsparse.bmat([[None, None]]),
                lambda: tsparse.vstack([])):
        with pytest.raises(ValueError):
            bad()


def test_hstack_keeps_non_canonical_inputs_unlabelled():
    data, row, col = np.array([1.0, 2.0]), np.array([0, 0]), np.array([1, 1])
    At = tsparse.csr_array((data, (row, col)), shape=(2, 3), device="cpu")
    Aj = jsparse.csr_array((data, (row, col)), shape=(2, 3))
    Ht, Hj = tsparse.hstack([At, At]), jsparse.hstack([Aj, Aj])
    assert not Ht.has_canonical_format
    Ht.sum_duplicates()
    Hj.sum_duplicates()
    same_csr(Hj, Ht)


def test_find_and_nonzero():
    S = rand_scipy(8, 9, 0.4, 5)
    S.data[::4] = 0.0
    Aj, At = pair(S)
    for a, b in zip(jsparse.find(Aj), tsparse.find(At)):
        same_dense(a, b)
    for a, b in zip(sp.find(S), tsparse.find(At)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kw", [
    dict(m=40, n=30, density=0.1, rng=0, format="csr"),
    dict(m=30, n=30, density=0.2, random_state=42),
    dict(m=20, n=25, density=0.3, rng=3, dtype=np.float32, format="csr"),
    dict(m=20, n=20, density=0.3, rng=5, dtype=np.int32, format="csr"),
    dict(m=20, n=20, density=0.3, rng=6, dtype=np.complex128,
         format="csr"),
    dict(m=25, n=25, density=0.2, rng=1, format="csr",
         data_rvs=lambda k: np.full(k, 2.5))])
def test_random_bitwise(kw):
    Rj = jsparse.random(**kw)
    Rt = tsparse.random(**kw, device="cpu")
    if kw.get("format", "coo") == "coo":
        same_coo(Rj, Rt)
    else:
        same_csr(Rj, Rt)


@pytest.mark.parametrize("kw", [
    dict(m=200, rng=0), dict(m=100, n=150, nnz_per_row=4, alpha=2.2, rng=1),
    dict(m=120, rng=2, directed=False),
    dict(m=80, rng=3, dtype=np.float32)])
def test_powerlaw_bitwise(kw):
    same_csr(jgallery.powerlaw(**kw), tsparse.powerlaw(**kw, device="cpu"))


@pytest.mark.parametrize("kw", [
    dict(scale=8, rng=0), dict(scale=7, nnz_per_row=4, a=0.45, b=0.15,
                               c=0.15, rng=1),
    dict(scale=6, rng=2, directed=False),
    dict(scale=6, rng=4, dtype=np.float32, format="coo")])
def test_rmat_bitwise(kw):
    Gj = jgallery.rmat(**kw)
    Gt = tsparse.rmat(**kw, device="cpu")
    if kw.get("format") == "coo":
        same_coo(Gj, Gt)
    else:
        same_csr(Gj, Gt)
        assert not Gt.has_canonical_format
        Gj.sum_duplicates()
        Gt.sum_duplicates()
        same_csr(Gj, Gt)
        same_csr(Gj + Gj.T, Gt + Gt.T)


def test_generators_reject_bad_arguments():
    with pytest.raises(ValueError):
        tsparse.random(4, 4, density=1.5, device="cpu")
    with pytest.raises(ValueError):
        tsparse.powerlaw(4, 5, directed=False, device="cpu")
    with pytest.raises(ValueError):
        tsparse.rmat(4, a=0.6, b=0.3, c=0.3, device="cpu")


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_slice_end_to_end(dtype, tol):
    """The slice on a 32x32 Poisson grid in both packages: ``diags`` in
    CSR, ``tril + triu`` rebuilt bit for bit, ``setdiag(k=2)`` (a new
    diagonal, so the band and its pack change), ``A @ x`` on the banded
    path, then CG on the symmetric operator ``A + A.T``."""
    grid = 32
    n = grid * grid
    main = np.full(n, 4.0)
    p1 = np.full(n - 1, -1.0)
    p1[np.arange(1, grid) * grid - 1] = 0.0
    pN = np.full(n - grid, -1.0)
    diagonals, offsets = [main, p1, p1, pN, pN], [0, 1, -1, grid, -grid]
    Aj = jsparse.diags(diagonals, offsets, shape=(n, n), format="csr",
                       dtype=dtype)
    At = tsparse.diags(diagonals, offsets, shape=(n, n), format="csr",
                       dtype=dtype, device="cpu")
    same_csr(Aj, At)
    Sj = jsparse.tril(Aj) + jsparse.triu(Aj, 1)
    St = tsparse.tril(At) + tsparse.triu(At, 1)
    same_csr(Sj, St)
    same_csr(Aj, St)
    x = np.random.default_rng(0).standard_normal(n).astype(dtype)
    assert torch.equal(St @ x, At @ x)
    St.setdiag(0.5, k=2)
    Sj.setdiag(0.5, k=2)
    y = St @ x
    assert St.spmv_path == ("dia-kernel" if dtype == np.float32
                            else "dia-torch")
    np.testing.assert_allclose(to_numpy(y), np.asarray(Sj @ x), rtol=tol,
                               atol=tol)
    Pj, Pt = Sj + Sj.T, St + St.T
    Pj.sort_indices()
    same_csr(Pj, Pt)
    b = np.ones(n, dtype)
    xj, itj = jlinalg.cg(Pj, b, rtol=1e-8 if dtype == np.float64 else 1e-5,
                         maxiter=2000)
    xt, itt = tlinalg.cg(Pt, b, rtol=1e-8 if dtype == np.float64 else 1e-5,
                         maxiter=2000)
    assert abs(int(itj) - int(itt)) <= 2
    np.testing.assert_allclose(to_numpy(xt), np.asarray(xj),
                               rtol=tol * 1e3 if dtype == np.float32
                               else 1e-8, atol=tol)
    res = np.linalg.norm(Pt.toscipy() @ to_numpy(xt).astype(np.float64) - 1)
    assert res <= (1e-7 if dtype == np.float64 else 1e-3) * np.sqrt(n)
