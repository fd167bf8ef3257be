# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's CSR arithmetic, comparisons, reductions, ufuncs and
structure maintenance against the JAX package.

The same matrices, made with numpy from a seed, go through both
packages; the port runs on ``device="cpu"``.  Structure (``indptr``,
``indices``) and result dtypes must agree exactly.  Values agree bit for
bit where both packages reduce in one order (a coordinate merged from at
most two entries, element-wise ops, gathers); elsewhere each test states
its tolerance, rtol = atol = 1e-6 for 32-bit values and 1e-12 for
64-bit ones (``TOL``): ``sum`` over all values and the transcendental
ufuncs, whose torch and XLA implementations round differently.  The
helpers here are shared by the other ``test_torch_*`` facade tests.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import interop
from legate_sparse_tpu_torch.utils import to_numpy

TOL = {"float32": 1e-6, "complex64": 1e-6, "float64": 1e-12,
       "complex128": 1e-12}
DTYPES = ["bool", "int32", "int64", "float32", "float64", "complex64",
          "complex128"]


def dname(dtype) -> str:
    """A dtype's name, for torch and numpy dtypes alike."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def host(x):
    """A numpy array (or a Python/numpy scalar as it is) of a result of
    either package."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    if isinstance(x, (int, float, complex, np.generic)):
        return x
    return np.asarray(x)


def rand_scipy(n, m, density, seed, dtype="float64"):
    """A canonical scipy CSR matrix with values of ``dtype``: signed
    values, small integers, complex with an imaginary part, or bool."""
    rng = np.random.default_rng(seed)
    S = sp.random(n, m, density=density, format="csr",
                  random_state=np.random.RandomState(seed),
                  data_rvs=rng.standard_normal)
    dt = np.dtype(dtype)
    if dt == np.bool_:
        S.data = S.data > 0
    elif np.issubdtype(dt, np.integer):
        S.data = np.round(S.data * 4) + np.sign(S.data)
    elif np.issubdtype(dt, np.complexfloating):
        S.data = S.data + 1j * rng.standard_normal(S.nnz)
    return S.astype(dt)


def pair(S):
    """The JAX package's and the port's ``csr_array`` of scipy ``S``."""
    return jsparse.csr_array(S), tsparse.csr_array(S, device="cpu")


def same_csr(Aj, At, tol=0.0, check_class=True):
    """``At`` (port) equals ``Aj`` (JAX): shape, dtype, indptr and
    indices exactly, values exactly or within ``tol``."""
    assert tuple(At.shape) == tuple(Aj.shape)
    assert dname(At.dtype) == dname(Aj.dtype)
    if check_class:
        assert type(At).__name__ == type(Aj).__name__
    dt, it, pt = interop.to_numpy_parts(At)
    np.testing.assert_array_equal(pt.astype(np.int64),
                                  np.asarray(Aj.indptr).astype(np.int64))
    np.testing.assert_array_equal(it.astype(np.int64),
                                  np.asarray(Aj.indices).astype(np.int64))
    if tol:
        np.testing.assert_allclose(dt, np.asarray(Aj.data), rtol=tol,
                                   atol=tol)
    else:
        np.testing.assert_array_equal(dt, np.asarray(Aj.data))


def same_dense(xj, xt, tol=0.0):
    """Two dense results (arrays, tensors, scalars) agree: kind of
    container (numpy for numpy), dtype and values."""
    if isinstance(xj, np.ndarray) or isinstance(xj, np.generic):
        assert isinstance(xt, (np.ndarray, np.generic)), type(xt)
    else:
        assert isinstance(xt, torch.Tensor), type(xt)
    a, b = host(xj), host(xt)
    assert dname(np.asarray(b).dtype) == dname(np.asarray(a).dtype)
    assert np.shape(a) == np.shape(b)
    if tol:
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(b, a)


# ---------------- transpose, diagonal, reductions ----------------

@pytest.mark.parametrize("N,M", [(5, 5), (12, 7), (7, 12)])
def test_transpose(N, M):
    Aj, At = pair(rand_scipy(N, M, 0.4, 11))
    same_csr(Aj.T, At.T)


@pytest.mark.parametrize("k", [-2, -1, 0, 1, 3])
def test_diagonal_and_trace(k):
    Aj, At = pair(rand_scipy(9, 9, 0.6, 4))
    same_dense(Aj.diagonal(k), At.diagonal(k))
    same_dense(Aj.trace(k), At.trace(k), tol=1e-12)


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("dtype", ["int32", "float32", "float64",
                                   "complex64"])
def test_sum_and_mean(axis, dtype):
    """Axis sums are segment sums in both packages' order: bit for bit;
    the sum of all values at ``TOL``."""
    Aj, At = pair(rand_scipy(8, 13, 0.4, 6, dtype))
    tol = TOL.get(dtype, 0.0) if axis is None else 0.0
    same_dense(Aj.sum(axis=axis), At.sum(axis=axis), tol=tol)
    same_dense(Aj.mean(axis=axis), At.mean(axis=axis),
               tol=TOL.get(dname(At.mean(axis=axis).dtype), 0.0))


def test_sum_dtype_and_out():
    Aj, At = pair(rand_scipy(8, 13, 0.4, 6, "float32"))
    same_dense(Aj.sum(axis=0, dtype=np.float64),
               At.sum(axis=0, dtype=np.float64))
    out = np.zeros(8, np.float32)
    res = At.sum(axis=1, out=out)
    assert res is out
    np.testing.assert_array_equal(out, np.asarray(Aj.sum(axis=1)))


def _minmax_case(kind):
    """Mixed signs so the implicit zeros matter; a full row and a full
    column; NaN and +-inf entries; an empty row."""
    rng = np.random.default_rng(3)
    D = np.where(rng.random((9, 7)) < 0.4, rng.standard_normal((9, 7)), 0.0)
    D[2, :] = -1.0 - rng.random(7)           # a full row, all negative
    D[:, 4] = 1.0 + rng.random(9)            # a full column, positive
    D[6, :] = 0.0                            # an empty row
    if kind == "nonfinite":
        D[0, 1], D[1, 3], D[3, 0], D[2, 2] = np.nan, np.inf, -np.inf, np.nan
    S = sp.csr_array(D)
    S.eliminate_zeros()
    return S


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("kind", ["finite", "nonfinite"])
def test_minmax(axis, op, kind):
    """max/min against the JAX package bit for bit, NaN and +-inf
    included (both propagate NaN), and the finite case against scipy."""
    S = _minmax_case(kind)
    Aj, At = pair(S)
    got = getattr(At, op)(axis=axis)
    same_dense(getattr(Aj, op)(axis=axis), got)
    if kind == "finite":
        want = getattr(S, op)(axis=axis)
        want = want if axis is None else want.toarray().ravel()
        np.testing.assert_array_equal(host(got), want)


def test_minmax_duplicates_and_zero_size():
    data, row, col = np.array([5.0, -5.0]), np.array([0, 0]), np.array([1, 1])
    Aj = jsparse.csr_array((data, (row, col)), shape=(2, 3))
    At = tsparse.csr_array((data, (row, col)), shape=(2, 3), device="cpu")
    same_dense(Aj.max(), At.max())
    E = tsparse.csr_array((np.zeros(0), np.zeros(0, np.int32),
                           np.zeros(6, np.int64)), shape=(5, 0), device="cpu")
    for kwargs in ({}, {"axis": 1}):
        with pytest.raises(ValueError):
            E.max(**kwargs)


def test_minmax_int_axis0():
    Aj, At = pair(rand_scipy(10, 6, 0.5, 2, "int64"))
    for op in ("max", "min"):
        for axis in (0, 1):
            same_dense(getattr(Aj, op)(axis=axis), getattr(At, op)(axis=axis))


# ---------------- ufuncs ----------------

UFUNCS = ["sin", "tan", "arcsin", "arctan", "sinh", "tanh", "arcsinh",
          "arctanh", "rint", "sign", "expm1", "log1p", "deg2rad", "rad2deg",
          "floor", "ceil", "trunc", "sqrt"]
REAL_ONLY = ("floor", "ceil", "trunc")


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in UFUNCS
    for dtype in ("float32", "float64", "complex64", "complex128")
    if not (name in REAL_ONLY and dtype.startswith("complex"))])
def test_unary_ufunc(name, dtype):
    """Each of the eighteen zero-preserving ufuncs against ``jnp``:
    structure exact, values at ``TOL``; inputs in (-0.9, 0.9), inside
    every domain, with values at x.5 for ``rint``'s half to even
    (``jnp`` has no complex floor, ceil or trunc)."""
    rng = np.random.default_rng(1)
    D = np.where(rng.random((9, 7)) < 0.5,
                 rng.uniform(-0.9, 0.9, (9, 7)), 0.0)
    if name == "rint":
        D = np.where(D != 0, np.round(D * 8) / 2 + 0.5, 0.0)
    if dtype.startswith("complex"):
        D = D + 1j * np.where(D != 0, rng.uniform(-0.9, 0.9, D.shape), 0)
    S = sp.csr_array(D.astype(dtype))
    S.eliminate_zeros()
    Aj, At = pair(S)
    # A complex sign is x / |x|: rounded as each library takes |x|.
    exact = (name in ("rint", "floor", "ceil", "trunc")
             or (name == "sign" and not dtype.startswith("complex")))
    same_csr(getattr(Aj, name)(), getattr(At, name)(),
             tol=0.0 if exact else TOL[dtype])


def test_unary_ufunc_dia():
    Dj = jsparse.diags([0.5, 0.25], [0, 1], shape=(5, 5))
    Dt = tsparse.diags([0.5, 0.25], [0, 1], shape=(5, 5), device="cpu")
    same_csr(Dj.sqrt().tocsr(), Dt.sqrt().tocsr(), tol=1e-12)


# ---------------- element-wise arithmetic and dtypes ----------------

def _dtype_pair_operands(da, db):
    """Two matrices of one shape whose patterns overlap in part."""
    return (rand_scipy(7, 9, 0.35, 1, da), rand_scipy(7, 9, 0.35, 2, db))


def _both(fn, jax_args, port_args):
    """``fn``'s result in each package, or (None, None) where the JAX
    package raises: there is no dtype to pin there (it cannot
    scatter-add bools for a bool ``maximum``; the port ORs them)."""
    try:
        rj = fn(*jax_args)
    except (TypeError, ValueError, NotImplementedError):
        return None, None
    return rj, fn(*port_args)


def _complex_tol(result, name, operand=None):
    """A complex product, quotient, power or modulus rounds as each
    library computes it (within a few ulp): ``TOL`` there, else exact."""
    dt = dname(result.dtype)
    src = dname(operand.dtype) if operand is not None else dt
    if "complex" not in src + dt or name not in (
            "multiply", "mul", "rmul", "div", "pow", "abs"):
        return 0.0
    return TOL[dt] if dt.startswith("complex") else TOL[src]


@pytest.mark.parametrize("da,db", [(a, b) for i, a in enumerate(DTYPES)
                                   for b in DTYPES[i:]])
def test_binary_ops_dtypes(da, db):
    """+, -, multiply, maximum and != for every dtype pair (promotion is
    symmetric: each unordered pair once, both orders of operands): the result
    dtype is the JAX package's (numpy's promotion between two sparse
    operands), the structure exact and the values bit for bit (each
    coordinate merges at most two entries), a complex product at
    ``TOL`` (``_complex_tol``)."""
    Sa, Sb = _dtype_pair_operands(da, db)
    Aj, At = pair(Sa)
    Bj, Bt = pair(Sb)
    ops = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
           "multiply": lambda a, b: a.multiply(b),
           "ne": lambda a, b: a != b}
    ops["maximum"] = lambda a, b: a.maximum(b)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, fn in ops.items():
            for (xj, xt), (yj, yt) in (((Aj, At), (Bj, Bt)),
                                       ((Bj, Bt), (Aj, At))):
                rj, rt = _both(fn, (xj, yj), (xt, yt))
                if rj is not None:
                    same_csr(rj, rt, tol=_complex_tol(rt, name))


SCALARS = [2, -3, 2.5, 1.5 - 2j, True, np.float32(2.0), np.int64(3),
           np.float64(0.5)]


@pytest.mark.parametrize("da", DTYPES)
def test_scalar_ops_dtypes(da):
    """``A * s``, ``s * A``, ``A / s``, ``A ** s``, ``-A``, ``abs(A)``
    and ``minimum``/``maximum(A, s)`` for Python scalars (weakly typed in
    ``jnp``) and numpy scalars (strong): dtypes as in the JAX package,
    values bit for bit; a complex product, quotient or modulus, and a
    negative or non-integral power, at ``TOL``."""
    Aj, At = pair(rand_scipy(6, 8, 0.4, 5, da))
    ops = {"mul": lambda a, s: a * s, "rmul": lambda a, s: s * a,
           "div": lambda a, s: a / s, "neg": lambda a, s: -a,
           "abs": lambda a, s: abs(a),
           "pow": lambda a, s: a ** s if not isinstance(s, complex)
           else a ** 2,
           "minimum": lambda a, s: a.minimum(s),
           "maximum": lambda a, s: a.maximum(s)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for s in SCALARS:
            for name, fn in ops.items():
                rj, rt = _both(fn, (Aj, s), (At, s))
                if rj is None:
                    continue
                tol = _complex_tol(rt, name, operand=At)
                if name == "pow" and not (isinstance(s, (int, np.integer))
                                          and s >= 0):
                    tol = TOL.get(dname(rt.dtype), 0.0)   # a pow() call
                same_csr(rj, rt, tol=tol)


def test_add_sub_values_and_scipy():
    Sa, Sb = rand_scipy(10, 9, 0.3, 1), rand_scipy(10, 9, 0.3, 2)
    Aj, At = pair(Sa)
    Bj, Bt = pair(Sb)
    same_csr(Aj + Bj, At + Bt)
    same_csr(Aj - Bj, At - Bt)
    # A scipy operand, and 0 + A (sum() starts at 0).
    same_csr(Aj + Sb, At + Sb)
    same_csr(0 + Aj, 0 + At)
    np.testing.assert_allclose((At - Bt).toscipy().toarray(),
                               (Sa - Sb).toarray(), atol=1e-14)
    with pytest.raises(NotImplementedError):
        At + np.ones((10, 9))
    with pytest.raises(ValueError):
        At + tsparse.csr_array(rand_scipy(9, 9, 0.3, 1), device="cpu")


def test_add_non_canonical_duplicates():
    """Three entries at one coordinate: the port sums them in stored
    order, the JAX package's unstable sort in some order: f64 at 1e-12."""
    data = np.array([0.1, 1e8, -1e8, 0.3])
    row, col = np.array([0, 0, 0, 1]), np.array([2, 2, 2, 0])
    Aj = jsparse.csr_array((data, (row, col)), shape=(2, 3))
    At = tsparse.csr_array((data, (row, col)), shape=(2, 3), device="cpu")
    Bj, Bt = pair(rand_scipy(2, 3, 0.5, 3))
    same_csr(Aj + Bj, At + Bt, tol=1e-12)


def test_multiply_dense_vector_and_broadcast(rng):
    Aj, At = pair(rand_scipy(7, 9, 0.4, 3))
    other = rng.random((7, 9))
    x = rng.random(9)
    for op in (other, x, x[None, :], rng.random((7, 1)),
               torch.from_numpy(other)):
        same_csr(Aj.multiply(np.asarray(op)), At.multiply(op))
    same_csr(Aj * other, At * other)
    with pytest.raises(ValueError):
        At.multiply(np.ones((3, 3)))


def test_multiply_sparse_and_formats():
    Sa, Sb = rand_scipy(8, 8, 0.5, 1), rand_scipy(8, 8, 0.5, 2)
    Aj, At = pair(Sa)
    Bj, Bt = pair(Sb)
    same_csr(Aj.multiply(Bj), At.multiply(Bt))
    same_csr(Aj.multiply(Sb), At.multiply(Sb))
    same_csr(Aj.multiply(Bj.tocsc()), At.multiply(Bt.tocsc()))
    same_csr(Aj.multiply(Bj.todia()), At.multiply(Bt.todia()))


def test_truediv():
    Sa, Sb = rand_scipy(6, 7, 0.5, 1), rand_scipy(6, 7, 0.5, 2)
    Aj, At = pair(Sa)
    Bj, Bt = pair(Sb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        same_dense(Aj / Bj, At / Bt)
    d = np.random.default_rng(0).random((6, 7)) + 0.5
    same_csr(Aj / d, At / d)
    same_csr(Aj / d[0], At / d[0])
    same_csr(Aj / 4.0, At / 4.0)


def test_power_and_duplicates():
    Aj, At = pair(rand_scipy(6, 6, 0.5, 9))
    same_csr(Aj.power(2), At.power(2))
    same_csr(Aj.power(3, dtype=np.float32), At.power(3, dtype=np.float32),
             tol=1e-6)
    with pytest.raises(NotImplementedError):
        At ** 0
    data, row, col = np.array([1.0, 2.0]), np.array([0, 0]), np.array([1, 1])
    Dj = jsparse.csr_array((data, (row, col)), shape=(2, 2))
    Dt = tsparse.csr_array((data, (row, col)), shape=(2, 2), device="cpu")
    same_csr(Dj.power(2), Dt.power(2))
    assert float(Dt.power(2).data[0]) == 9.0


def test_conj_abs_neg_complex():
    Aj, At = pair(rand_scipy(6, 6, 0.5, 9, "complex128"))
    same_csr(Aj.conj(), At.conj())
    same_csr(Aj.conjugate(), At.conjugate())
    same_csr(abs(Aj), abs(At), tol=TOL["float64"])    # |z| rounds as hypot
    same_csr(-Aj, -At)
    Rj, Rt = pair(rand_scipy(6, 6, 0.5, 9))
    same_csr(Rj.conj(), Rt.conj())


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_count_nonzero(axis):
    S = rand_scipy(7, 5, 0.5, 4)
    S.data[::3] = 0.0                         # stored zeros do not count
    Aj, At = pair(S)
    got = At.count_nonzero(axis=axis)
    want = Aj.count_nonzero(axis=axis)
    if axis is None:
        assert isinstance(got, int) and got == want
    else:
        same_dense(want, got)


@pytest.mark.parametrize("name", ["maximum", "minimum"])
def test_maximum_minimum(name):
    Sa, Sb = rand_scipy(7, 6, 0.4, 1), rand_scipy(7, 6, 0.4, 2)
    Aj, At = pair(Sa)
    Bj, Bt = pair(Sb)
    same_csr(getattr(Aj, name)(Bj), getattr(At, name)(Bt))
    same_csr(getattr(Aj, name)(Sb), getattr(At, name)(Sb))
    # A scalar on the zero-preserving side stays sparse; the other side
    # is dense-shaped and warns.
    keep = -0.5 if name == "maximum" else 0.5
    same_csr(getattr(Aj, name)(keep), getattr(At, name)(keep))
    with pytest.warns(tsparse.SparseEfficiencyWarning):
        got = getattr(At, name)(-keep)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        same_csr(getattr(Aj, name)(-keep), got)


@pytest.mark.parametrize("name", ["eq", "ne", "lt", "gt", "le", "ge"])
def test_comparisons(name):
    """Against a scalar, a sparse operand and a dense one: a bool sparse
    array (or a dense numpy bool array for a dense operand), warning
    where the result is dense-shaped, as in the JAX package."""
    op = {"eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
          "lt": lambda a, b: a < b, "gt": lambda a, b: a > b,
          "le": lambda a, b: a <= b, "ge": lambda a, b: a >= b}[name]
    Sa, Sb = rand_scipy(6, 7, 0.4, 1), rand_scipy(6, 7, 0.4, 2)
    Sb[0:2] = Sa[0:2]                          # some equal entries
    Sb = sp.csr_array(Sb)
    Aj, At = pair(Sa)
    Bj, Bt = pair(Sb)
    dense = np.random.default_rng(0).standard_normal((6, 7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        same_csr(op(Aj, Bj), op(At, Bt))
        same_csr(op(Aj, Sb), op(At, Sb))
        for s in (0.25, -0.25, 0):
            same_csr(op(Aj, s), op(At, s))
        same_dense(op(Aj, dense), op(At, dense))
    fill_true = bool(getattr(np, {"eq": "equal", "ne": "not_equal",
                                  "lt": "less", "gt": "greater",
                                  "le": "less_equal",
                                  "ge": "greater_equal"}[name])(0, 0))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        op(At, Bt)
    assert any(issubclass(w.category, tsparse.SparseEfficiencyWarning)
               for w in rec) == fill_true


def test_unhashable_and_nonzero():
    Aj, At = pair(rand_scipy(6, 7, 0.4, 1))
    with pytest.raises(TypeError):
        hash(At)
    for a, b in zip(Aj.nonzero(), At.nonzero()):
        same_dense(a, b)


def test_tensor_and_array_left_operands_reach_rmul():
    """``tensor * A`` and ``ndarray * A`` are ``A``'s ``__rmul__``:
    torch returns NotImplemented for the sparse operand rather than
    coercing it, numpy defers by ``__array_priority__``."""
    Aj, At = pair(rand_scipy(5, 5, 0.5, 2))
    x = np.arange(5.0)
    assert torch.Tensor.__mul__(torch.from_numpy(x), At) is NotImplemented
    same_csr(x * Aj, torch.from_numpy(x) * At)
    same_csr(x * Aj, x * At)
    same_csr(2.0 * Aj, torch.tensor(2.0, dtype=torch.float64) * At)


# ---------------- structure maintenance ----------------

def _unsorted_with_duplicates():
    data = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    indices = np.array([2, 0, 2, 1, 1, 0])
    indptr = np.array([0, 3, 3, 6])
    return data, indices, indptr


def test_sort_indices_sum_duplicates_canonical_flags():
    data, indices, indptr = _unsorted_with_duplicates()
    Aj = jsparse.csr_array((data, indices, indptr), shape=(3, 3))
    At = tsparse.csr_array((data, indices, indptr), shape=(3, 3),
                           device="cpu")
    assert At.has_sorted_indices == Aj.has_sorted_indices is False
    assert At.has_canonical_format == Aj.has_canonical_format is False
    Sj, St = jsparse.csr_array(Aj), tsparse.csr_array(At)
    Sj.sort_indices()
    St.sort_indices()
    same_csr(Sj, St)          # stable: duplicates keep their order
    assert St.has_sorted_indices and not St.has_canonical_format
    assert Aj.sum_duplicates() is None and At.sum_duplicates() is None
    same_csr(Aj, At)
    assert At.has_canonical_format and At.has_sorted_indices


def test_eliminate_zeros_and_getnnz():
    S = rand_scipy(8, 6, 0.5, 1)
    S.data[::2] = 0.0
    Aj, At = pair(S)
    for axis in (None, 0, 1):
        same_dense(Aj.getnnz(axis=axis), At.getnnz(axis=axis)) \
            if axis is not None else (Aj.getnnz() == At.getnnz())
    assert Aj.eliminate_zeros() is None and At.eliminate_zeros() is None
    same_csr(Aj, At)
    assert At.nnz == int((S.data != 0).sum())


def test_eliminate_zeros_invalidates_caches(rng):
    """A matrix whose band cache was built: after ``eliminate_zeros``
    drops a whole diagonal, ``A @ x`` takes the new band, not the old."""
    n = 40
    S = sp.diags([np.ones(n - 1), 2 * np.ones(n), np.ones(n - 3)],
                 [-1, 0, 3], format="csr")
    row_ids = np.repeat(np.arange(n), np.diff(S.indptr))
    S.data[S.indices - row_ids == 3] = 0.0     # stored zeros
    At = tsparse.csr_array(S, device="cpu")
    x = rng.standard_normal(n)
    At @ x
    assert At._dia is not None and len(At._dia_offsets) == 3
    At.eliminate_zeros()
    y = At @ x
    assert At._dia_offsets == (-1, 0)
    np.testing.assert_allclose(to_numpy(y), S @ x, rtol=1e-12)


def test_todia_asformat_and_host_conversions():
    Aj, At = pair(rand_scipy(9, 9, 0.3, 7))
    Dj, Dt = Aj.todia(), At.todia()
    assert Dt.offsets_tuple == tuple(int(o) for o in np.asarray(Dj.offsets))
    np.testing.assert_array_equal(to_numpy(Dt.data), np.asarray(Dj.data))
    for fmt in ("csr", "csc", "coo", "dia"):
        assert At.asformat(fmt).format == Aj.asformat(fmt).format == fmt
    E = tsparse.csr_array((4, 5), device="cpu")
    assert E.todia().nnz == 0 and E.todia().data.shape == (0, 0)
    assert (At.todok() != Aj.todok()).nnz == 0
    assert (At.tolil() != Aj.tolil()).nnz == 0
    for axis in (None, 0, 1):
        np.testing.assert_array_equal(At.argmax(axis=axis),
                                      Aj.argmax(axis=axis))
        np.testing.assert_array_equal(At.argmin(axis=axis),
                                      Aj.argmin(axis=axis))
    same_csr(Aj.reshape((3, 27)), At.reshape((3, 27)))
    with pytest.raises(ValueError):
        At.reshape(81)
    assert str(At) == str(Aj)


def test_resize():
    Aj, At = pair(rand_scipy(9, 8, 0.5, 4))
    for shape in ((5, 6), (12, 10)):
        Aj.resize(*shape)
        At.resize(shape)
        same_csr(Aj, At)


# ---------------- utils and ops/convert helpers ----------------

@pytest.mark.parametrize("db", DTYPES)
@pytest.mark.parametrize("da", ["bool", "int32", "float32", "complex64"])
def test_find_and_cast_to_common_type(da, db):
    """numpy's promotion between two sparse operands, as the JAX
    package's ``utils.find_common_type``/``cast_to_common_type``."""
    from legate_sparse_tpu import utils as jutils
    from legate_sparse_tpu_torch import utils as tutils

    (Aj, At), (Bj, Bt) = pair(rand_scipy(4, 5, 0.5, 1, da)), pair(
        rand_scipy(4, 5, 0.5, 2, db))
    assert dname(tutils.find_common_type(At, Bt)) == dname(
        jutils.find_common_type(Aj, Bj))
    for a, b in zip(jutils.cast_to_common_type(Aj, Bj),
                    tutils.cast_to_common_type(At, Bt)):
        same_csr(a, b)
    x = np.arange(5, dtype=np.float32)
    _, xt = tutils.cast_to_common_type(At, x)
    _, xj = jutils.cast_to_common_type(Aj, x)
    same_dense(xj, xt)


def test_asarray_1d_and_fill_out():
    from legate_sparse_tpu import utils as jutils
    from legate_sparse_tpu_torch import utils as tutils

    for x in (np.arange(4.0), np.arange(4.0)[:, None], [1, 2, 3]):
        same_dense(jutils.asarray_1d(x), tutils.asarray_1d(x, "cpu"))
    same_dense(jutils.asarray_1d(np.arange(3), dtype=np.float32),
               tutils.asarray_1d(np.arange(3), "cpu", dtype=np.float32))
    with pytest.raises(ValueError):
        tutils.asarray_1d(np.ones((2, 2)), "cpu")
    out = np.zeros(3, np.float32)
    assert tutils.fill_out(torch.arange(3.0), out) is out
    np.testing.assert_array_equal(out, [0.0, 1.0, 2.0])
    with pytest.raises(ValueError):
        tutils.fill_out(torch.arange(3.0), np.zeros(4))


def test_compact_mask_and_select_rows():
    """``ops/convert.py``'s mask compaction and row selection against the
    JAX package's: the same elements in the same order."""
    import jax.numpy as jnp
    from legate_sparse_tpu.ops import convert as jconvert

    from legate_sparse_tpu_torch.ops import convert as tconvert

    rng = np.random.default_rng(2)
    mask = rng.random(50) < 0.3
    a, b = rng.standard_normal(50), rng.integers(0, 9, 50)
    got = tconvert.compact_mask(torch.from_numpy(mask),
                                (torch.from_numpy(a), torch.from_numpy(b)))
    want = jconvert.compact_mask(jnp.asarray(mask),
                                 (jnp.asarray(a), jnp.asarray(b)),
                                 int(mask.sum()))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    S = rand_scipy(12, 7, 0.4, 8)
    rows = np.array([3, 0, 11, 3, 7])
    nnz_out = int((S.indptr[rows + 1] - S.indptr[rows]).sum())
    want = jconvert.select_rows(jnp.asarray(S.data), jnp.asarray(S.indices),
                                jnp.asarray(S.indptr), jnp.asarray(rows),
                                nnz_out)
    got = tconvert.select_rows(torch.from_numpy(S.data),
                               torch.from_numpy(S.indices),
                               torch.from_numpy(S.indptr.astype(np.int64)),
                               torch.from_numpy(rows), nnz_out)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


def test_toscipy_is_a_copy():
    """scipy's in-place ``sum_duplicates`` on a ``toscipy()`` result must
    not reach the port's tensors, which share no memory with it even on
    the CPU."""
    data, row, col = np.array([1.0, 2.0, 4.0]), np.array([0, 0, 1]), \
        np.array([1, 1, 0])
    At = tsparse.csr_array((data, (row, col)), shape=(2, 2), device="cpu")
    S = At.toscipy()
    S.sum_duplicates()
    S.data[:] = -1.0
    assert At.nnz == 3
    np.testing.assert_array_equal(to_numpy(At.data), data)
    np.testing.assert_array_equal(to_numpy(At.indptr), [0, 2, 3])


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_complex_products_arithmetic_trace_diagonal(dtype):
    """The non-Pallas part of the JAX package's complex tests through
    the facade: SpMV, SpMM, the conjugate transpose's product, SpGEMM,
    ``+``, ``multiply``, ``trace`` and ``diagonal``, against the JAX
    package at ``TOL`` (products sum in each package's order; a complex
    product rounds as each library computes it)."""
    rng = np.random.default_rng(1)
    S1 = rand_scipy(40, 40, 0.15, 3, dtype)
    S2 = rand_scipy(40, 40, 0.15, 4, dtype)
    (Aj, At), (Bj, Bt) = pair(S1), pair(S2)
    tol = TOL[dtype]
    x = (rng.normal(size=40) + 1j * rng.normal(size=40)).astype(dtype)
    X = (rng.normal(size=(40, 6))
         + 1j * rng.normal(size=(40, 6))).astype(dtype)
    same_dense(Aj @ x, At @ x, tol=tol)
    same_dense(Aj @ X, At @ X, tol=tol)
    same_dense(Aj.T.conj() @ x, At.T.conj() @ x, tol=tol)
    same_csr(Aj @ Bj, At @ Bt, tol=tol)
    same_csr(Aj + Bj, At + Bt)
    same_csr(Aj.multiply(Bj), At.multiply(Bt), tol=tol)
    same_dense(Aj.trace(), At.trace(), tol=tol)
    same_dense(Aj.diagonal(), At.diagonal())
