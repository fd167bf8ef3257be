# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Two rules of the port pinned against the JAX package.

1. bf16 values of the random generators (``random``, ``powerlaw``,
   ``rmat``): the port rounds f64 -> f32 -> bf16, the JAX package
   ``astype(bfloat16)``; both round through f32.  At the double-rounding
   literal 1 + 2^-8 + 2^-30 (1.0 through f32, 1 + 2^-7 rounded directly)
   both give 1.0, and seeded draws agree bit for bit (values, indices
   and indptr).
2. The result dtypes of the zero-preserving ufuncs, the scalar
   arithmetic and the reductions on integer and bool matrices, beyond
   the ``jnp`` rules copied into ``base.py``: equal to the JAX package's
   except at the divergences recorded in ROADMAP queue 3 (``DIVERGENT``,
   each pinned to what either side does).  Values agree bit for bit
   where the result is an integer, to 1e-6 (f32) and 1e-12 (f64) where a
   transcendental is rounded by each library.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import legate_sparse_tpu as jsparse
from legate_sparse_tpu import gallery as jgallery

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch.types import to_numpy_dtype

LITERAL = 1 + 2.0**-8 + 2.0**-30


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_bf16_double_rounding_literal():
    rvs = lambda k: np.full(k, LITERAL)  # noqa: E731
    Aj = jsparse.random(4, 4, density=1.0, dtype=jnp.bfloat16,
                        data_rvs=rvs, format="csr")
    At = tsparse.random(4, 4, density=1.0, dtype=torch.bfloat16,
                        data_rvs=rvs, format="csr", device="cpu")
    np.testing.assert_array_equal(
        np.asarray(Aj.data.astype(jnp.float32)), np.ones(16, np.float32))
    assert torch.equal(At.data.float(), torch.ones(16))


@pytest.mark.parametrize("name, seed", [("random", 0), ("powerlaw", 1),
                                        ("rmat", 2), ("random", 11)])
def test_bf16_seeded_draws_bitwise(name, seed):
    if name == "random":
        Aj = jsparse.random(64, 64, density=0.3, rng=seed,
                            dtype=jnp.bfloat16, format="csr")
        At = tsparse.random(64, 64, density=0.3, rng=seed,
                            dtype=torch.bfloat16, format="csr", device="cpu")
    elif name == "powerlaw":
        Aj = jgallery.powerlaw(64, rng=seed, dtype=jnp.bfloat16)
        At = tsparse.powerlaw(64, rng=seed, dtype=torch.bfloat16,
                              device="cpu")
    else:
        Aj = jgallery.rmat(6, rng=seed, dtype=jnp.bfloat16)
        At = tsparse.rmat(6, rng=seed, dtype=torch.bfloat16, device="cpu")
    assert At.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(Aj.data).view(np.uint16),
                                  _bits(At.data))
    np.testing.assert_array_equal(np.asarray(Aj.indices).astype(np.int64),
                                  At.indices.numpy().astype(np.int64))
    np.testing.assert_array_equal(np.asarray(Aj.indptr).astype(np.int64),
                                  At.indptr.numpy().astype(np.int64))


UFUNCS = ("sin", "tan", "arcsin", "arctan", "sinh", "tanh", "arcsinh",
          "arctanh", "rint", "sign", "expm1", "log1p", "deg2rad", "rad2deg",
          "floor", "ceil", "trunc", "sqrt")
OPS = {
    "mul_float": lambda A: A * 2.5, "mul_int": lambda A: A * 2,
    "truediv_int": lambda A: A / 2, "pow2": lambda A: A ** 2,
    "abs": lambda A: abs(A), "multiply_self": lambda A: A.multiply(A),
    "add_self": lambda A: A + A, "sum": lambda A: A.sum(),
    "sum_axis0": lambda A: A.sum(axis=0), "sum_axis1": lambda A: A.sum(axis=1),
    "mean": lambda A: A.mean(), "max": lambda A: A.max(),
}
OPS.update({name: (lambda A, _n=name: getattr(A, _n)()) for name in UFUNCS})
INT_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8")
# (dtype, op) -> (the JAX package's result, the port's): an exception
# name where a side refuses.  ROADMAP queue 3 records each.
DIVERGENT = {
    ("bool", "sign"): ("TypeError", "bool"),
    ("bool", "sum_axis0"): ("TypeError", "bool"),
    ("bool", "sum_axis1"): ("TypeError", "bool"),
    ("uint8", "sum"): ("uint64", "int64"),
}
# Both refuse, each with its own exception.
BOTH_REFUSE = {("bool", "neg")}


def _int_matrix(dtype: str):
    rng = np.random.default_rng(5)
    M = sp.random(6, 7, density=0.5, random_state=rng, format="csr")
    M.data = rng.integers(-3, 4, M.nnz).astype(np.float64)
    if dtype == "uint8":
        M.data = np.abs(M.data)
    return M.astype(dtype)


def _outcome(fn, A):
    """(dtype name or exception name, values as numpy or None)."""
    try:
        r = fn(A)
    except (TypeError, RuntimeError, ValueError) as e:
        return type(e).__name__, None
    d = r.dtype
    if isinstance(d, torch.dtype):
        name = "bool" if d == torch.bool else np.dtype(
            to_numpy_dtype(d)).name
    else:
        name = np.dtype(d).name
    if hasattr(r, "todense"):
        r = r.todense()
    if isinstance(r, torch.Tensor):
        vals = r.double().numpy() if r.dtype != torch.bool else r.numpy()
    else:
        vals = np.asarray(r)
    return name, vals


@pytest.mark.parametrize("dtype", INT_DTYPES)
@pytest.mark.parametrize("op", sorted(OPS) + ["neg"])
def test_integer_result_dtypes_match_jax(dtype, op):
    M = _int_matrix(dtype)
    fn = OPS.get(op, lambda A: -A)
    (dj, vj) = _outcome(fn, jsparse.csr_array(M))
    (dt, vt) = _outcome(fn, tsparse.csr_array(M, device="cpu"))
    if (dtype, op) in DIVERGENT:
        assert (dj, dt) == DIVERGENT[(dtype, op)]
        return
    if (dtype, op) in BOTH_REFUSE:
        assert vj is None and vt is None
        return
    assert dt == dj, f"{dtype} {op}: JAX {dj}, port {dt}"
    vj = np.asarray(vj, dtype=np.float64 if dj != "bool" else bool)
    if dj in ("float32", "float64") and op in UFUNCS:
        tol = 1e-6 if dj == "float32" else 1e-12
        np.testing.assert_allclose(vt, vj, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(np.asarray(vt, dtype=vj.dtype), vj)
