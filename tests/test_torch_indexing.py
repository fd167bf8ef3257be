# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's CSR indexing, ``setdiag`` and the caches of mutated
matrices against the JAX package, and the ``csr_matrix`` flavour.

Both packages take the same seeded matrices; the port runs on
``device="cpu"``.  Indexing gathers stored entries, so structure and
values agree bit for bit; ``A @ x`` after a mutation is held to the
JAX package's product at rtol = atol = 1e-12 (f64) or 1e-6 (f32), and
to scipy's f64 product at the same tolerance.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch.utils import to_numpy

from test_torch_csr_ops import pair, rand_scipy, same_csr, same_dense


@pytest.fixture(scope="module")
def mats():
    return pair(rand_scipy(25, 18, 0.25, 0))


def test_single_row_and_element(mats):
    Aj, At = mats
    same_csr(Aj[3], At[3])
    same_csr(Aj[-1], At[-1])
    same_csr(Aj[4, :], At[4, :])
    for i, j in [(0, 0), (3, 7), (24, 17), (-1, -1), (np.int64(2), 5)]:
        same_dense(Aj[i, j], At[i, j])


@pytest.mark.parametrize("key", [slice(2, 10), slice(None, None, 3),
                                 slice(10, 2, -2), slice(None)])
def test_row_slices(mats, key):
    Aj, At = mats
    same_csr(Aj[key], At[key])


def test_row_arrays_and_masks(mats):
    Aj, At = mats
    idx = np.array([5, 1, 22, 1, -3])
    same_csr(Aj[idx], At[idx])
    same_csr(Aj[list(idx)], At[torch.from_numpy(idx)])
    m = np.zeros(25, bool)
    m[[2, 9, 11]] = True
    same_csr(Aj[m], At[m])


@pytest.mark.parametrize("key", [
    (slice(None), slice(3, 12)), (slice(2, 8), slice(None, None, 2)),
    (slice(None), np.array([0, 17, 4, 4])), (np.array([1, 7]), slice(2, 9)),
    (3, slice(None, 5)), (slice(None), 6), (slice(0, 20, 3), -2),
    (np.array([2, 2, 9]), np.array([5, 0, 17]))])
def test_column_restriction_and_pointwise(mats, key):
    Aj, At = mats
    rj, rt = Aj[key], At[key]
    if isinstance(rj, np.ndarray):
        same_dense(rj, rt)
    else:
        same_csr(rj, rt)


def test_pointwise_two_dimensional_and_many(mats):
    """Index arrays of shape (2, 2) keep their shape; more than 64 pairs
    take the global binary search instead of per-row probes."""
    Aj, At = mats
    rows = np.array([[0, 1], [2, 3]])
    cols = np.array([[0, 1], [2, 3]])
    same_dense(Aj[rows, cols], At[rows, cols])
    rng = np.random.default_rng(4)
    r, c = rng.integers(0, 25, 200), rng.integers(0, 18, 200)
    same_dense(Aj[r, c], At[r, c])


def test_duplicates_are_summed_on_access():
    data = np.array([1.0, 2.0, 4.0])
    row, col = np.array([0, 0, 1]), np.array([1, 1, 0])
    Aj = jsparse.csr_array((data, (row, col)), shape=(2, 2))
    At = tsparse.csr_array((data, (row, col)), shape=(2, 2), device="cpu")
    same_dense(Aj[0, 1], At[0, 1])
    assert At[0, 1] == 3.0
    r, c = np.arange(70) % 2, np.arange(70) // 35
    same_dense(Aj[r, c], At[r, c])


@pytest.mark.parametrize("key", [(25, 0), (0, 18), (-26, 0)])
def test_out_of_range(mats, key):
    _, At = mats
    with pytest.raises(IndexError):
        At[key]


def test_index_errors(mats):
    _, At = mats
    with pytest.raises(IndexError):
        At[np.array([0, 30])]
    with pytest.raises(IndexError):
        At[np.ones(5, bool)]
    with pytest.raises(IndexError):
        At[np.array([1, 2]), np.array([1, 2, 3])]
    with pytest.raises(IndexError):
        At[1, 2, 3]


# ---------------- setdiag and the caches ----------------

@pytest.fixture
def fresh():
    S = sp.random(20, 15, density=0.3, random_state=0, format="csr")
    S.data -= 0.5
    return S, jsparse.csr_array(S), tsparse.csr_array(S, device="cpu")


@pytest.mark.parametrize("k", [0, 2, -3])
def test_setdiag_overwrite_and_insert(fresh, k):
    """The port sorts an inserted entry into its row's column order
    (scipy's layout; the JAX package appends it), so the structure is
    held to the JAX package's after ``sort_indices``, the values and the
    product to scipy's."""
    S, Aj, At = fresh
    rng = np.random.default_rng(k + 5)
    length = min(20 + min(k, 0), 15 - max(k, 0))
    vals = rng.standard_normal(length)
    S = S.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        S.setdiag(vals, k=k)
    assert Aj.setdiag(vals, k=k) is None and At.setdiag(vals, k=k) is None
    assert At.has_canonical_format
    Aj.sort_indices()
    same_csr(Aj, At)
    np.testing.assert_array_equal(At.toscipy().toarray(), S.toarray())
    x = rng.standard_normal(15)
    np.testing.assert_allclose(to_numpy(At @ x), S @ x, rtol=1e-12,
                               atol=1e-12)


def test_setdiag_scalar_short_and_bounds(fresh):
    S, Aj, At = fresh
    Aj.setdiag(7.5)
    At.setdiag(7.5)
    Aj.sort_indices()
    same_csr(Aj, At)
    Aj.setdiag([1.0, 2.0], k=1)      # shorter than the diagonal
    At.setdiag([1.0, 2.0], k=1)
    Aj.sort_indices()
    same_csr(Aj, At)
    At.setdiag([], k=0)              # no values: nothing changes
    same_csr(Aj, At)
    for k in (15, -20):
        with pytest.raises(ValueError):
            At.setdiag(1.0, k=k)


def test_setdiag_on_duplicates():
    data = np.array([1.0, 2.0, 3.0])
    row, col = np.array([0, 0, 1]), np.array([0, 0, 2])
    Aj = jsparse.csr_array((data, (row, col)), shape=(3, 3))
    At = tsparse.csr_array((data, (row, col)), shape=(3, 3), device="cpu")
    Aj.setdiag(9.0)
    At.setdiag(9.0)
    Aj.sort_indices()
    same_csr(Aj, At)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_setdiag_then_dot_takes_the_new_band(dtype, tol):
    """Trouble spot on the main path: a banded matrix whose band, kernel
    pack and row ids are cached; a value-only ``setdiag`` and then one
    that inserts a diagonal must both reach ``A @ x`` (the banded path,
    over the new band), while a full-slice view and a ``_with_data``
    sibling made before keep the old values."""
    n = 64
    rng = np.random.default_rng(7)
    diagonals = [rng.standard_normal(n - 1), rng.standard_normal(n),
                 rng.standard_normal(n - 1)]
    S = sp.diags(diagonals, [-1, 0, 1], format="csr", dtype=dtype)
    At = tsparse.csr_array(S, device="cpu")
    Aj = jsparse.csr_array(S)
    x = rng.standard_normal(n).astype(dtype)
    At @ x
    view = At[:]
    sibling = At._with_data(At.data * 2)
    old = S @ x
    path = "dia-kernel" if dtype == np.float32 else "dia-torch"
    for val, k in ((5.0, 0), (1.0, 2)):
        At.setdiag(val, k=k)
        Aj.setdiag(val, k=k)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            S = S.copy()
            S.setdiag(val, k=k)
        y = At @ x
        assert At.spmv_path == path
        np.testing.assert_allclose(to_numpy(y), S.astype(np.float64) @ x,
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(to_numpy(y), np.asarray(Aj @ x),
                                   rtol=tol, atol=tol)
    assert At._dia_offsets == (-1, 0, 1, 2)
    np.testing.assert_allclose(to_numpy(view @ x), old, rtol=tol, atol=tol)
    np.testing.assert_allclose(to_numpy(sibling @ x), 2 * old, rtol=tol,
                               atol=tol)


def test_full_slice_mutation_isolated(fresh):
    S, Aj, At = fresh
    B = At[:]
    B.setdiag(9.0)
    np.testing.assert_array_equal(At.toscipy().toarray(), S.toarray())
    assert float(B.toscipy().toarray()[0, 0]) == 9.0


def test_data_setter_invalidates_values_only(fresh):
    S, _, At = fresh
    x = np.ones(15)
    At @ x
    rid = At._row_ids
    At.data = At.data * 3
    assert At._row_ids is rid and At._dia is None and At._ell is None
    np.testing.assert_allclose(to_numpy(At @ x), 3 * (S @ x), rtol=1e-12)
    with pytest.raises(ValueError):
        At.data = np.ones(3)


# ---------------- csr_matrix ----------------

def test_csr_matrix_flavour():
    S = rand_scipy(6, 6, 0.5, 3)
    Mj, Mt = jsparse.csr_matrix(S), tsparse.csr_matrix(S, device="cpu")
    x = np.random.default_rng(0).standard_normal(6)
    # Products sum in each package's order: f64 at 1e-12.
    same_dense(Mj * x, Mt * x, tol=1e-12)             # * is the product
    same_dense(x * Mj, x * Mt, tol=1e-12)             # x @ A
    same_dense(x[None, :] * Mj, x[None, :] * Mt, tol=1e-12)
    same_csr(Mj * Mj, Mt * Mt, tol=1e-12)
    same_csr(Mj * 2.0, Mt * 2.0)
    same_csr(2.0 * Mj, 2.0 * Mt)
    for n in (0, 1, 3):
        same_csr(Mj ** n, Mt ** n, tol=1e-12)
    with pytest.raises(ValueError):
        Mt ** -1
    same_csr(Mj.getrow(2), Mt.getrow(2))
    same_csr(Mj.getcol(4), Mt.getcol(4))
    C = rand_scipy(5, 5, 0.5, 4, "complex128")
    same_csr(jsparse.csr_matrix(C).getH(), tsparse.csr_matrix(
        C, device="cpu").getH())
    assert type(Mt.T).__name__ == "csr_matrix"
    assert type(Mt.copy()).__name__ == "csr_matrix"
    with pytest.raises(NotImplementedError):
        np.ones((6, 6)) @ tsparse.csr_array(S, device="cpu")
