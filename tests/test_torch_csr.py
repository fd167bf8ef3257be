# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's CSR construction and SpMV dispatch against the JAX package.

The same matrices, made with numpy from a seed, are built by both
packages.  Structure (``data``, ``indices``, ``indptr``) must agree bit
for bit; ``A @ x`` agrees at rtol = atol = 1e-6 in f32 (the paths sum
in another order) and 1e-12 in f64, and the port records the path it
took on each branch of the dispatch: DIA, BSR (forced), ELL and
csr-rowids.  The port runs on ``device="cpu"``, where every kernel
wrapper takes its plain version.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse
from legate_sparse_tpu.settings import settings as jsettings

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import interop
from legate_sparse_tpu_torch.settings import settings as tsettings


def _parts_equal(A_jax, A_port):
    dj, ij, pj = (np.asarray(A_jax.data), np.asarray(A_jax.indices),
                  np.asarray(A_jax.indptr))
    dt, it, pt = interop.to_numpy_parts(A_port)
    assert tuple(A_jax.shape) == tuple(A_port.shape)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(it.astype(np.int64), ij.astype(np.int64))
    np.testing.assert_array_equal(pt.astype(np.int64), pj.astype(np.int64))
    assert dt.dtype == dj.dtype


def _irregular(rows, cols, rng, long_row=False, dtype=np.float32):
    """Canonical CSR with a few nonzeros per row at random columns; with
    ``long_row``, row 0 is dense, which puts ELL over its budget."""
    A = sp.random(rows, cols, density=4.0 / cols, format="lil",
                  random_state=rng, dtype=dtype)
    A[np.arange(rows), rng.integers(0, cols, rows)] = 1.0  # no empty row
    if long_row:
        A[0, :] = rng.standard_normal(cols).astype(dtype)
    A = A.tocsr()
    A.sort_indices()
    return A


@pytest.mark.parametrize("offsets,n,m", [((-1, 0, 1), 50, 50),
                                         ((-7, 0, 2, 9), 64, 80),
                                         ((-30, -1, 0, 1, 30), 900, 900)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_diags_tocsr_bitwise(offsets, n, m, dtype, rng):
    diagonals = [rng.standard_normal(min(n + min(o, 0), m - max(o, 0)))
                 for o in offsets]
    diagonals[0][::5] = 0.0          # zeros are dropped by tocsr
    Aj = jsparse.diags(diagonals, list(offsets), shape=(n, m), format="csr",
                       dtype=dtype)
    At = tsparse.diags(diagonals, list(offsets), shape=(n, m), format="csr",
                       dtype=dtype, device="cpu")
    _parts_equal(Aj, At)
    Dj = jsparse.diags(diagonals, list(offsets), shape=(n, m), dtype=dtype)
    Dt = tsparse.diags(diagonals, list(offsets), shape=(n, m), dtype=dtype,
                       device="cpu")
    assert Dt.format == "dia" and Dt.nnz == Dj.nnz
    _parts_equal(Dj.tocsr(), Dt.tocsr())


def test_constructors_bitwise(rng):
    S = _irregular(70, 90, rng)
    # From (data, indices, indptr).
    Aj = jsparse.csr_array((S.data, S.indices, S.indptr), shape=S.shape)
    At = tsparse.csr_array((S.data, S.indices, S.indptr), shape=S.shape,
                           device="cpu")
    _parts_equal(Aj, At)
    # From scipy.
    _parts_equal(jsparse.csr_array(S),
                 tsparse.csr_array(S, device="cpu"))
    # From dense.
    dense = S.toarray()
    Dj = jsparse.csr_array(dense)
    Dt = tsparse.csr_array(dense, device="cpu")
    _parts_equal(Dj, Dt)
    assert Dt.has_canonical_format
    np.testing.assert_array_equal(Dt.todense().numpy(), dense)
    np.testing.assert_array_equal(Dt.toscipy().toarray(), dense)


def test_has_canonical_format_from_parts():
    data = np.ones(3, np.float32)
    indptr = np.array([0, 2, 3])
    sorted_ = tsparse.csr_array((data, np.array([0, 2, 1]), indptr),
                                shape=(2, 3), device="cpu")
    unsorted = tsparse.csr_array((data, np.array([2, 0, 1]), indptr),
                                 shape=(2, 3), device="cpu")
    dup = tsparse.csr_array((data, np.array([1, 1, 0]), indptr),
                            shape=(2, 3), device="cpu")
    assert sorted_.has_canonical_format
    assert not unsorted.has_canonical_format
    assert not dup.has_canonical_format
    for A in (sorted_, unsorted, dup):
        Aj = jsparse.csr_array((data, A.indices.numpy(), indptr),
                               shape=(2, 3))
        assert A.has_canonical_format == Aj.has_canonical_format


def _check_dot(S, path, rng, dtype=np.float32, tol=1e-6):
    Aj = jsparse.csr_array(S.astype(dtype))
    At = interop.csr_from_parts(np.asarray(Aj.data), np.asarray(Aj.indices),
                                np.asarray(Aj.indptr), Aj.shape,
                                device="cpu")
    x = rng.standard_normal(S.shape[1]).astype(dtype)
    y = At @ x
    assert At.spmv_path == path
    assert y.dtype == At.dtype and tuple(y.shape) == (S.shape[0],)
    np.testing.assert_allclose(y.numpy(), np.asarray(Aj @ x), rtol=tol,
                               atol=tol)
    return At, Aj, x


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_dot_dia_path(dtype, tol, rng):
    S = sp.diags([rng.standard_normal(400) for _ in range(3)], [-3, 0, 4],
                 shape=(400, 400), format="csr")
    path = "dia-kernel" if dtype == np.float32 else "dia-torch"
    _check_dot(S, path, rng, dtype, tol)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_dot_ell_path(dtype, tol, rng):
    _check_dot(_irregular(300, 300, rng), "ell", rng, dtype, tol)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_dot_csr_rowids_path(dtype, tol, rng):
    _check_dot(_irregular(300, 300, rng, long_row=True), "csr-rowids", rng,
               dtype, tol)


def test_dot_csr_path_on_promotion(rng):
    """An f32 matrix times an f64 vector promotes the matrix to f64; the
    promoted copy has no structure cache and takes plain CSR."""
    S = _irregular(200, 200, rng)
    Aj = jsparse.csr_array(S)
    At = tsparse.csr_array(S, device="cpu")
    x = rng.standard_normal(200)
    y = At @ x
    assert At.spmv_path == "csr" and y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), np.asarray(Aj @ x), rtol=1e-12,
                               atol=1e-12)


@pytest.fixture
def bsr_forced(monkeypatch):
    monkeypatch.setattr(jsettings, "bsr_force", True)
    monkeypatch.setattr(tsettings, "bsr_force", True)


def test_dot_bsr_path_forced(bsr_forced, rng):
    """Under ``bsr_force`` both packages take BSR for a matrix whose
    present blocks fit the budget: f32 at rtol = atol = 1e-5 (each
    block's dot is summed in another order)."""
    S = _irregular(256, 256, rng)
    _check_dot(S, "bsr", rng, tol=1e-5)


def test_bsr_not_built_on_cpu_without_force(rng):
    At = tsparse.csr_array(_irregular(256, 256, rng), device="cpu")
    assert At._get_bsr() is None
    At @ np.ones(256, np.float32)
    assert At.spmv_path == "ell"


def test_dot_column_vector_and_out(rng):
    S = _irregular(120, 80, rng)
    Aj = jsparse.csr_array(S)
    At = tsparse.csr_array(S, device="cpu")
    x = rng.standard_normal((80, 1)).astype(np.float32)
    y = At @ x
    assert tuple(y.shape) == (120, 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(Aj @ x), rtol=1e-6,
                               atol=1e-6)
    out = torch.empty(120, dtype=torch.float32)
    res = At.dot(torch.from_numpy(x[:, 0]), out=out)
    assert res is out
    np.testing.assert_allclose(out.numpy(), y.numpy()[:, 0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        At @ np.ones(81, np.float32)
    # A matrix operand takes the SpMM branch (tests/test_torch_spmm.py).
    X = np.ones((80, 3), np.float32)
    Y = At @ X
    assert tuple(Y.shape) == (120, 3)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Aj @ X), rtol=1e-6,
                               atol=1e-6)


def test_interop_round_trip(rng):
    S = _irregular(60, 40, rng)
    At = interop.csr_from_parts(S.data, S.indices, S.indptr, S.shape,
                                device="cpu")
    d, i, p = interop.to_numpy_parts(At)
    np.testing.assert_array_equal(d, S.data)
    np.testing.assert_array_equal(i, S.indices)
    np.testing.assert_array_equal(p, S.indptr)
    data = rng.standard_normal((3, 40))
    offsets = np.array([-2, 0, 7])
    Dt = interop.dia_from_parts(data, offsets, (60, 40), device="cpu")
    dd, oo = interop.to_numpy_parts(Dt)
    np.testing.assert_array_equal(dd, data)
    np.testing.assert_array_equal(oo, offsets)
    Dj = jsparse.dia_array((data, offsets), shape=(60, 40))
    _parts_equal(Dj.tocsr(), Dt.tocsr())


def test_interop_bf16_from_jax(rng):
    import jax.numpy as jnp

    S = sp.diags([rng.standard_normal(100) for _ in range(3)], [-1, 0, 1],
                 shape=(100, 100), format="csr", dtype=np.float32)
    Aj = jsparse.csr_array(S).astype(jnp.bfloat16)
    At = interop.csr_from_parts(np.asarray(Aj.data), np.asarray(Aj.indices),
                                np.asarray(Aj.indptr), Aj.shape, device="cpu")
    assert At.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        At.data.float().numpy(), np.asarray(Aj.data.astype(jnp.float32)))
