# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``coo_array``, ``csc_array``, the rest of ``dia_array``
and the interop of the new formats against the JAX package.

Both packages take the same seeded matrices; the port runs on
``device="cpu"``.  Conversions, transposes, element-wise ops and sums
along a stored axis agree bit for bit (structure and values); products
through ``A @ x`` and ``A @ B`` sum in each package's own order and are
held at rtol = atol = 1e-12 (f64).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import interop, linalg
from legate_sparse_tpu_torch.utils import to_numpy

from test_torch_csr_ops import host, rand_scipy, same_csr, same_dense


def same_coo(Cj, Ct, tol=0.0):
    assert type(Ct).__name__ == type(Cj).__name__
    assert tuple(Ct.shape) == tuple(Cj.shape) and Ct.nnz == Cj.nnz
    d, r, c = interop.to_numpy_parts(Ct)
    np.testing.assert_array_equal(r, np.asarray(Cj.row))
    np.testing.assert_array_equal(c, np.asarray(Cj.col))
    np.testing.assert_allclose(d, np.asarray(Cj.data), rtol=tol, atol=tol)


def same_csc(Cj, Ct, tol=0.0):
    assert type(Ct).__name__ == type(Cj).__name__
    same_csr(Cj._t, Ct._t, tol=tol, check_class=False)
    assert tuple(Ct.shape) == tuple(Cj.shape)


@pytest.fixture(scope="module")
def coo_pair():
    S = sp.random(30, 40, density=0.15, random_state=0, format="coo")
    return S, jsparse.coo_array(S), tsparse.coo_array(S, device="cpu")


@pytest.fixture(scope="module")
def csc_pair():
    S = sp.random(40, 30, density=0.2, random_state=0, format="csc")
    return S, jsparse.csc_array(S), tsparse.csc_array(S, device="cpu")


# ---------------- coo_array ----------------

def test_coo_roundtrips(coo_pair):
    S, Cj, Ct = coo_pair
    same_coo(Cj, Ct)
    same_dense(Cj.toarray(), Ct.toarray())       # numpy in both
    np.testing.assert_array_equal(Ct.toscipy().toarray(), S.toarray())
    same_csr(Cj.tocsr(), Ct.tocsr())
    same_csc(Cj.tocsc(), Ct.tocsc())
    same_coo(Cj.T, Ct.T)
    same_coo(Cj.copy(), Ct.copy())
    assert Ct.tocoo() is Ct and Ct.asformat("coo") is Ct
    assert Ct.asformat("csr").format == "csr"
    assert Ct.ndim == 2 and Ct.device.type == "cpu"


def test_coo_from_ijv_and_duplicates():
    data = np.array([1.0, 2.0, 3.0])
    row, col = np.array([0, 0, 1]), np.array([2, 2, 0])
    Cj = jsparse.coo_array((data, (row, col)), shape=(3, 4))
    Ct = tsparse.coo_array((data, (row, col)), shape=(3, 4), device="cpu")
    same_coo(Cj, Ct)
    assert Cj.sum_duplicates() is None and Ct.sum_duplicates() is None
    same_coo(Cj, Ct)
    assert Ct.nnz == 2
    # Shape inferred from the coordinates.
    same_coo(jsparse.coo_array((data, (row, col))),
             tsparse.coo_array((data, (row, col)), device="cpu"))


def test_coo_from_other_formats(coo_pair):
    S, Cj, Ct = coo_pair
    for src in (S.tocsc(), S.todense()):
        same_coo(jsparse.coo_array(np.asarray(src) if not sp.issparse(src)
                                   else src),
                 tsparse.coo_array(np.asarray(src) if not sp.issparse(src)
                                   else src, device="cpu"))
    same_coo(jsparse.coo_array(Cj.tocsr().todia()),
             tsparse.coo_array(Ct.tocsr().todia()))
    same_coo(jsparse.coo_array(Cj.tocsc()), tsparse.coo_array(Ct.tocsc()))


def test_coo_ops(coo_pair):
    S, Cj, Ct = coo_pair
    x = np.random.default_rng(0).standard_normal(40)
    same_dense(Cj @ x, Ct @ x, tol=1e-12)
    same_dense(Cj.dot(x), Ct.dot(x), tol=1e-12)
    for scalar_op in (lambda a: 2.0 * a, lambda a: a * 3, lambda a: -a):
        same_coo(scalar_op(Cj), scalar_op(Ct))
    same_coo(Cj.multiply(Cj), Ct.multiply(Ct))
    same_coo(Cj.astype(np.float32), Ct.astype(np.float32))
    for axis in (None, 0, 1):
        same_dense(Cj.sum(axis=axis), Ct.sum(axis=axis),
                   tol=1e-12 if axis is None else 0.0)
    same_dense(Cj.diagonal(1), Ct.diagonal(1))
    same_csr(Cj + Cj, Ct + Ct)
    same_csr(Cj.maximum((Cj * 0.5).tocsr()), Ct.maximum((Ct * 0.5).tocsr()))
    same_csr(Cj != Cj.T.T, Ct != Ct.T.T)


def test_coo_matrix_flavour(coo_pair):
    S, _, _ = coo_pair
    M = sp.random(8, 8, density=0.4, random_state=3, format="coo")
    Mj, Mt = jsparse.coo_matrix(M), tsparse.coo_matrix(M, device="cpu")
    x = np.arange(8.0)
    same_dense(Mj * x, Mt * x, tol=1e-12)
    same_dense(x * Mj, x * Mt, tol=1e-12)
    same_coo(Mj * 2.0, Mt * 2.0)
    Pj, Pt = Mj ** 2, Mt ** 2
    assert type(Pt).__name__ == "coo_matrix"
    np.testing.assert_allclose(Pt.toarray(), Pj.toarray(), rtol=1e-12,
                               atol=1e-12)


def test_coo_complex_conj():
    C = rand_scipy(6, 6, 0.5, 2, "complex128").tocoo()
    same_coo(jsparse.coo_array(C).conj(),
             tsparse.coo_array(C, device="cpu").conj())


def test_solver_accepts_coo(rng):
    n = 60
    S = (sp.random(n, n, density=0.2, random_state=1) + sp.eye(n) * n)
    S = ((S + S.T) / 2).tocoo()
    Ct = tsparse.coo_array(S, device="cpu")
    b = rng.standard_normal(n)
    x, _ = linalg.cg(Ct.tocsr(), b, rtol=1e-10, maxiter=400)
    np.testing.assert_allclose(to_numpy(Ct @ x), b, rtol=1e-6, atol=1e-6)


# ---------------- csc_array ----------------

def test_csc_roundtrips(csc_pair):
    S, Cj, Ct = csc_pair
    same_csc(Cj, Ct)
    assert Ct.nnz == S.nnz
    same_dense(Cj.toarray(), Ct.toarray())
    np.testing.assert_array_equal(Ct.toscipy().toarray(), S.toarray())
    same_csr(Cj.tocsr(), Ct.tocsr())
    same_coo(Cj.tocoo(), Ct.tocoo())
    same_csc(Cj.copy(), Ct.copy())
    assert Ct.tocsc() is Ct and Ct.asformat("csc") is Ct
    assert Ct.asformat("dia").format == "dia"
    d, i, p = interop.to_numpy_parts(Ct)
    np.testing.assert_array_equal(i, S.indices)
    np.testing.assert_array_equal(p, S.indptr)


def test_csc_from_triple_dense_and_csr():
    S = sp.random(20, 25, density=0.3, random_state=1, format="csc")
    same_csc(jsparse.csc_array((S.data, S.indices, S.indptr), shape=S.shape),
             tsparse.csc_array((S.data, S.indices, S.indptr), shape=S.shape,
                               device="cpu"))
    D = S.toarray()
    same_csc(jsparse.csc_array(D), tsparse.csc_array(D, device="cpu"))
    R = sp.csr_array(S)
    same_csc(jsparse.csc_array(jsparse.csr_array(R)),
             tsparse.csc_array(tsparse.csr_array(R, device="cpu")))
    with pytest.raises(ValueError):
        tsparse.csc_array((S.data, S.indices, S.indptr), device="cpu")


def test_csc_products(csc_pair, rng):
    S, Cj, Ct = csc_pair
    x = rng.standard_normal(30)
    same_dense(Cj @ x, Ct @ x, tol=1e-12)
    X = rng.standard_normal((30, 4))
    same_dense(Cj @ X, Ct @ X, tol=1e-12)
    B = sp.random(30, 20, density=0.2, random_state=2, format="csr")
    Bj, Bt = jsparse.csr_array(B), tsparse.csr_array(B, device="cpu")
    same_csr(Cj @ Bj, Ct @ Bt, tol=1e-12)
    same_csr(Bj.T @ Cj.T, Bt.T @ Ct.T, tol=1e-12)
    same_csr(Cj @ B, Ct @ B, tol=1e-12)


def test_csc_transpose_diagonal_sums(csc_pair):
    S, Cj, Ct = csc_pair
    same_csr(Cj.T, Ct.T)
    for k in (-2, 0, 3):
        same_dense(Cj.diagonal(k), Ct.diagonal(k))
    for axis in (None, 0, 1, -1):
        same_dense(Cj.sum(axis=axis), Ct.sum(axis=axis),
                   tol=1e-12 if axis is None else 0.0)
    with pytest.raises(ValueError):
        Ct.sum(axis=2)


def test_csc_scalar_and_elementwise(csc_pair):
    S, Cj, Ct = csc_pair
    same_csc(Cj * 2.0, Ct * 2.0)
    same_csc(2.0 * Cj, 2.0 * Ct)
    same_csc(-Cj, -Ct)
    same_csc(Cj.astype(np.float32), Ct.astype(np.float32))
    same_csc(Cj.multiply(Cj), Ct.multiply(Ct))
    x = np.arange(30.0)
    same_csc(Cj.multiply(x), Ct.multiply(x))
    same_csr(Cj - Cj, Ct - Ct)
    same_csr(Cj / 2.0, Ct / 2.0)
    assert Ct.count_nonzero() == Cj.count_nonzero()
    same_dense(Cj.trace(), Ct.trace(), tol=1e-12)


def test_csc_mutation_does_not_alias(csc_pair):
    """``T`` and ``tocsr`` hand out wrappers: mutating them leaves the
    array (and its cached CSR form) as it was."""
    S, _, _ = csc_pair
    Ct = tsparse.csc_array(S, device="cpu")
    T = Ct.T
    T.setdiag(99.0)
    np.testing.assert_array_equal(Ct.toarray(), S.toarray())
    R1 = Ct.tocsr()
    R1.setdiag(-5.0)
    np.testing.assert_array_equal(Ct.tocsr().toscipy().toarray(),
                                  S.toarray())


def test_csc_complex_and_matrix_flavour():
    C = rand_scipy(6, 6, 0.5, 2, "complex128").tocsc()
    same_csc(jsparse.csc_array(C).conj(),
             tsparse.csc_array(C, device="cpu").conj())
    Mj = jsparse.csc_matrix(C)
    Mt = tsparse.csc_matrix(C, device="cpu")
    x = np.arange(6.0)
    same_dense(Mj * x, Mt * x, tol=1e-12)
    same_csc(Mj * 2.0, Mt * 2.0)
    Pt = Mt ** 2
    assert type(Pt).__name__ == "csc_matrix"
    np.testing.assert_allclose(Pt.toarray(), (Mj ** 2).toarray(),
                               rtol=1e-12, atol=1e-12)


def test_ctor_dtype_applies(csc_pair):
    S, _, _ = csc_pair
    Ct = tsparse.csc_array(S, dtype=np.float32, device="cpu")
    assert Ct.dtype == torch.float32
    Ct2 = tsparse.csc_array(Ct, dtype=np.float64)
    assert Ct2.dtype == torch.float64


# ---------------- dia_array ----------------

@pytest.mark.parametrize("shape,offsets", [((9, 9), (-2, 0, 3)),
                                           ((7, 11), (-1, 0, 4, 6)),
                                           ((11, 6), (-5, -1, 2))])
def test_dia_transpose_astype_and_surface(shape, offsets):
    rng = np.random.default_rng(sum(shape))
    data = rng.standard_normal((len(offsets), shape[1]))
    Dj = jsparse.dia_array((data, np.array(offsets)), shape=shape)
    Dt = tsparse.dia_array((data, np.array(offsets)), shape=shape,
                           device="cpu")
    Tj, Tt = Dj.T, Dt.T
    assert Tt.shape == tuple(Tj.shape)
    assert Tt.offsets_tuple == tuple(int(o) for o in np.asarray(Tj.offsets))
    np.testing.assert_array_equal(to_numpy(Tt.data), np.asarray(Tj.data))
    same_csr(Tj.tocsr(), Tt.tocsr())
    A32j, A32t = Dj.astype(np.float32), Dt.astype(np.float32)
    assert A32t.format == "dia" and A32t.dtype == torch.float32
    same_csr(A32j.tocsr(), A32t.tocsr())
    # The CompressedBase surface, through CSR.
    for axis in (None, 0, 1):
        same_dense(Dj.sum(axis=axis), Dt.sum(axis=axis),
                   tol=1e-12 if axis is None else 0.0)
        same_dense(Dj.max(axis=axis), Dt.max(axis=axis))
    same_csr(Dj * Dj, Dt * Dt)
    same_csr(Dj + Dj, Dt + Dt)
    same_csr(Dj != Dj.T.T, Dt != Dt.T.T)
    same_csr(abs(Dj), abs(Dt))
    assert type(-Dt).__name__ == "dia_array"
    np.testing.assert_array_equal(to_numpy((-Dt).data), -data)


def test_dia_matrix_power():
    Dj = jsparse.dia_matrix((np.ones((2, 5)), np.array([0, 1])), shape=(5, 5))
    Dt = tsparse.dia_matrix((np.ones((2, 5)), np.array([0, 1])), shape=(5, 5),
                            device="cpu")
    Pj, Pt = Dj ** 3, Dt ** 3
    assert type(Pt).__name__ == "dia_matrix"
    same_csr(Pj.tocsr(), Pt.tocsr())


# ---------------- interop ----------------

def test_interop_coo_and_csc_parts(rng):
    S = sp.random(12, 9, density=0.3, random_state=4, format="coo")
    Ct = interop.coo_from_parts(S.data, S.row, S.col, S.shape, device="cpu")
    d, r, c = interop.to_numpy_parts(Ct)
    np.testing.assert_array_equal(d, S.data)
    np.testing.assert_array_equal(r, S.row)
    np.testing.assert_array_equal(c, S.col)
    Cj = jsparse.coo_array(S)
    same_coo(Cj, interop.coo_from_parts(np.asarray(Cj.data),
                                        np.asarray(Cj.row),
                                        np.asarray(Cj.col), Cj.shape,
                                        device="cpu"))
    K = S.tocsc()
    Kt = interop.csc_from_parts(K.data, K.indices, K.indptr, K.shape,
                                device="cpu")
    for a, b in zip(interop.to_numpy_parts(Kt), (K.data, K.indices,
                                                 K.indptr)):
        np.testing.assert_array_equal(a, b)
    same_csc(jsparse.csc_array(K), Kt)
    with pytest.raises(TypeError):
        interop.to_numpy_parts(host(np.ones(3)))
