# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's SpMM (``A @ X`` for a dense X of k columns) against the
JAX package's.

The same matrices and X, made with numpy from a seed, go through both
packages; the port runs on ``device="cpu"``, where each kernel wrapper
takes its plain version.  Tolerances:

- DIA kernel, f32: the plain version equals the interpret-mode Pallas
  kernel (``pallas_dia_spmm``) bit for bit: both add the diagonals in
  offset order in f32, with X zeroed at holes and out of range first;
- DIA kernel, bf16: a numpy emulation of the stated rule (product
  rounded to bf16, sum in f32) bit for bit; against the interpret-mode
  kernel, which keeps the product exact in f32, one bf16 rounding per
  product and one of the result: |Δ| <= 2^-8 Σ|a x| + 2^-8 |y|;
- BSR kernel: f32 at rtol = atol = 1e-5 (each block's 128-term dot is
  summed in another order); bf16 results at rtol = atol = 1e-2 (about
  two bf16 ulps: the f32 sums differ in order, then round to bf16);
- the plain routes (``dia_spmm``, ``ell_spmm``, csr-rowids, csr) and
  the dispatch: rtol = atol = 1e-6 in f32 and 1e-12 in f64.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import legate_sparse_tpu as jsparse
from legate_sparse_tpu.ops import bsr as jbsr
from legate_sparse_tpu.ops import dia_ops as jdia_ops
from legate_sparse_tpu.ops import pallas_dia
from legate_sparse_tpu.ops import spmv as jspmv
from legate_sparse_tpu.settings import settings as jsettings

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import interop
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch.ops import bsr as tbsr
from legate_sparse_tpu_torch.ops import dia_kernel
from legate_sparse_tpu_torch.ops import dia_ops as tdia_ops
from legate_sparse_tpu_torch.ops import spmv as tspmv
from legate_sparse_tpu_torch.settings import settings as tsettings


def _port(A_jax):
    return interop.csr_from_parts(np.asarray(A_jax.data),
                                  np.asarray(A_jax.indices),
                                  np.asarray(A_jax.indptr), A_jax.shape,
                                  device="cpu")


def _band(n, offsets, rng, m=None, holes=0):
    m = n if m is None else m
    diags = [rng.standard_normal(max(n, m)).astype(np.float32)
             for _ in offsets]
    if holes:
        for d in diags:
            d[::holes] = 0.0
    A = sp.diags(diags, offsets, shape=(n, m), format="csr",
                 dtype=np.float32)
    A.eliminate_zeros()
    return A


def _jax_spmm(Aj, X):
    dia_data, offsets, mask = Aj._get_dia()
    packed = pallas_dia.pack_band(dia_data, offsets, Aj.shape, mask=mask)
    tile = pallas_dia._spmm_tile(packed, X.shape[1])
    return np.asarray(pallas_dia.pallas_dia_spmm(
        packed.rdata, packed.rmask, jnp.asarray(X), packed.offsets,
        packed.shape, tile, interpret=True).astype(jnp.float32))


DIA_CASES = {
    "exact-k1": (500, 500, (-2, -1, 0, 1, 2), 0, 1),
    "exact-k16": (500, 500, (-2, -1, 0, 1, 2), 0, 16),
    "holey-k7": (600, 600, (-1, 0, 1), 5, 7),
    "rect-k7": (300, 420, (-3, 0, 4), 0, 7),
    "large-offsets-k3": (2500, 2500, (-1100, 0, 1100), 0, 3),
}


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_spmm_plain_matches_interpret_kernel(case, rng):
    n, m, offsets, holes, k = DIA_CASES[case]
    Aj = jsparse.csr_array(_band(n, list(offsets), rng, m=m, holes=holes))
    assert (Aj._get_dia()[2] is not None) == bool(holes)
    X = rng.standard_normal((m, k)).astype(np.float32)
    packed = _port(Aj)._get_dia_pack()
    Yt = dia_kernel.dia_spmm(packed, torch.from_numpy(X))
    assert Yt.dtype == torch.float32
    np.testing.assert_array_equal(Yt.numpy(), _jax_spmm(Aj, X))


def test_dia_spmm_nonfinite_x_at_holes(rng):
    n = 300
    main = np.ones(n, np.float32)
    off1 = np.ones(n - 1, np.float32)
    off1[10] = 0.0                       # hole at (10, 11)
    A_sp = sp.diags([main, off1], [0, 1], format="csr")
    A_sp.eliminate_zeros()
    Aj = jsparse.csr_array(A_sp)
    X = np.ones((n, 3), np.float32)
    X[11] = np.inf
    Yj = _jax_spmm(Aj, X)
    Yt = dia_kernel.dia_spmm(_port(Aj)._get_dia_pack(), torch.from_numpy(X))
    assert np.all(np.isfinite(Yt[10].numpy()))
    np.testing.assert_array_equal(Yt.numpy(), Yj)


def test_dia_spmm_bf16_product_rounded(rng):
    bf16 = jnp.bfloat16
    n, k = 800, 5
    Aj = jsparse.csr_array(_band(n, [-3, -1, 0, 1, 3], rng)).astype(bf16)
    X = np.asarray(jnp.asarray(rng.standard_normal((n, k)), bf16))
    packed = _port(Aj)._get_dia_pack()
    assert packed.rdata.dtype == torch.bfloat16
    Yt = dia_kernel.dia_spmm(
        packed, torch.from_numpy(X.astype(np.float32)).to(torch.bfloat16))
    assert Yt.dtype == torch.bfloat16
    Yt = Yt.float().numpy()
    rdata = packed.rdata.float().numpy()
    Xf = X.astype(np.float32)
    acc = np.zeros((n, k), np.float32)
    mag = np.zeros((n, k), np.float32)
    for d, off in enumerate(packed.offsets):
        xs = np.zeros((n, k), np.float32)
        lo, hi = max(0, -off), min(n, n - off)
        xs[lo:hi] = Xf[lo + off:hi + off]
        prod = rdata[d][:, None] * xs             # exact in f32
        acc = acc + prod.astype(bf16).astype(np.float32)
        mag += np.abs(prod)
    np.testing.assert_array_equal(Yt, acc.astype(bf16).astype(np.float32))
    Yj = _jax_spmm(Aj, X)
    assert np.all(np.abs(Yt - Yj) <= 2.0**-8 * (mag + np.abs(Yj)))


def test_dia_spmm_wrapper_rejects_bad_inputs(rng):
    packed = _port(jsparse.csr_array(_band(64, [0, 1], rng)))._get_dia_pack()
    with pytest.raises(ValueError):
        dia_kernel.dia_spmm(packed, torch.zeros(63, 2))
    with pytest.raises(ValueError):
        dia_kernel.dia_spmm(packed, torch.zeros(64, dia_kernel.SPMM_MAX_K + 1))
    with pytest.raises(TypeError):
        dia_kernel.dia_spmm(packed, torch.zeros(64, 2, dtype=torch.float64))
    assert not dia_kernel.spmm_supported(packed, torch.zeros(64, 0))


def _random_csr(rows, cols, density, seed):
    return sp.random(rows, cols, density=density, format="csr",
                     random_state=np.random.default_rng(seed),
                     dtype=np.float32)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_bsr_matmat_f32_matches_jax(k):
    A = _random_csr(300, 200, 0.04, seed=21)
    X = np.random.default_rng(22).standard_normal((200, k)).astype(
        np.float32)
    pack = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    Yj = np.asarray(jbsr.BsrStructure(*pack, 300, 200).matmat(
        X, interpret=True))
    st = tbsr.BsrStructure(*tbsr.bsr_pack(A.data, A.indices, A.indptr,
                                          A.shape, max_expand=1e9),
                           300, 200, device="cpu")
    Yt = st.matmat(torch.from_numpy(X))
    assert Yt.dtype == torch.float32 and tuple(Yt.shape) == (300, k)
    np.testing.assert_allclose(Yt.numpy(), Yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Yt.numpy(), A @ X, rtol=1e-5, atol=1e-5)


def test_bsr_matmat_bf16_matches_jax():
    A = _random_csr(256, 256, 0.04, seed=3)
    X = np.random.default_rng(2).standard_normal((256, 6)).astype(np.float32)
    Xb = jnp.asarray(X, jnp.bfloat16)
    pack = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    Yj = np.asarray(jbsr.BsrStructure(*pack, 256, 256, dtype=jnp.bfloat16)
                    .matmat(Xb, interpret=True).astype(jnp.float32))
    st = tbsr.BsrStructure(*tbsr.bsr_pack(A.data, A.indices, A.indptr,
                                          A.shape, max_expand=1e9),
                           256, 256, dtype=torch.bfloat16, device="cpu")
    Yt = st.matmat(torch.from_numpy(np.array(Xb.astype(jnp.float32))))
    assert Yt.dtype == torch.bfloat16
    np.testing.assert_allclose(Yt.float().numpy(), Yj, rtol=1e-2, atol=1e-2)


def test_bsr_spmm_wrapper_rejects_bad_inputs():
    A = _random_csr(256, 256, 0.03, seed=4)
    st = tbsr.BsrStructure(*tbsr.bsr_pack(A.data, A.indices, A.indptr,
                                          A.shape, max_expand=1e9),
                           256, 256, device="cpu")
    with pytest.raises(ValueError):
        tbsr.bsr_spmm(st.blkT, st.brow, st.bcol, st.bptr,
                      torch.zeros((200, 4)), st.nbr)
    with pytest.raises(ValueError):
        tbsr.bsr_spmm(st.blkT, st.brow, st.bcol, st.bptr,
                      torch.zeros((256, tbsr.SPMM_MAX_K + 1)), st.nbr)
    with pytest.raises(TypeError):
        tbsr.bsr_spmm(st.blkT, st.brow, st.bcol, st.bptr,
                      torch.zeros((256, 4), dtype=torch.float64), st.nbr)
    with pytest.raises(ValueError):
        st.matmat(torch.zeros((256, tbsr.SPMM_MAX_K + 1)))


def test_plain_routes_match_jax(rng):
    """``dia_spmm``/``dia_spmm_masked``, ``ell_spmm``, ``csr_spmm`` and
    ``csr_spmm_rowids`` against their JAX counterparts, f64."""
    X = rng.standard_normal((400, 6))
    Aj = jsparse.csr_array(_band(400, [-4, 0, 2], rng, holes=3)
                           .astype(np.float64))
    dia_data, offs, mask = Aj._get_dia()
    args = (torch.from_numpy(np.array(dia_data)),
            torch.from_numpy(np.array(mask)), torch.from_numpy(X))
    np.testing.assert_allclose(
        tdia_ops.dia_spmm_masked(*args, offs, Aj.shape).numpy(),
        np.asarray(jdia_ops.dia_spmm_masked(dia_data, mask, X, offs,
                                            Aj.shape)), rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(
        tdia_ops.dia_spmm(args[0], args[2], offs, Aj.shape).numpy(),
        np.asarray(jdia_ops.dia_spmm(dia_data, X, offs, Aj.shape)),
        rtol=1e-12, atol=1e-12)
    S = _random_csr(400, 400, 0.02, seed=9).astype(np.float64)
    St = tsparse.csr_array(S, device="cpu")
    ej = jspmv.ell_pack(S.data, S.indices, S.indptr, 400,
                        int(np.diff(S.indptr).max()), xp=np)
    et = St._get_ell()
    np.testing.assert_allclose(
        tspmv.ell_spmm(*et, torch.from_numpy(X)).numpy(),
        np.asarray(jspmv.ell_spmm(*[jnp.asarray(a) for a in ej], X)),
        rtol=1e-12, atol=1e-12)
    Sj = jsparse.csr_array(S)
    for fn_t, fn_j, struct_t, struct_j in (
            (tspmv.csr_spmm, jspmv.csr_spmm, St.indptr, Sj.indptr),
            (tspmv.csr_spmm_rowids, jspmv.csr_spmm_rowids, St._get_row_ids(),
             Sj._get_row_ids())):
        np.testing.assert_allclose(
            fn_t(St.data, St.indices, struct_t, torch.from_numpy(X),
                 400).numpy(),
            np.asarray(fn_j(Sj.data, Sj.indices, struct_j, X, 400)),
            rtol=1e-12, atol=1e-12)


@pytest.fixture
def bsr_forced(monkeypatch):
    monkeypatch.setattr(jsettings, "bsr_force", True)
    monkeypatch.setattr(tsettings, "bsr_force", True)


def _long_row(S):
    S = S.tolil()
    S[0, :] = 1.0
    return S.tocsr()


@pytest.mark.parametrize("route", ["dia-kernel", "dia-torch", "ell",
                                   "csr-rowids", "csr"])
def test_dot_dispatch_matches_jax(route, rng):
    n, k = 300, 4
    if route == "dia-kernel":
        S, X = _band(n, [-2, 0, 1], rng, holes=4), np.float32
    elif route == "dia-torch":
        S, X = _band(n, [-2, 0, 1], rng).astype(np.float64), np.float64
    elif route == "ell":
        S, X = _random_csr(n, n, 0.02, seed=5), np.float32
    elif route == "csr-rowids":
        S, X = _long_row(_random_csr(n, n, 0.01, seed=6)), np.float32
    else:     # an f64 X promotes the f32 matrix
        S, X = _random_csr(n, n, 0.02, seed=7), np.float64
    Xn = rng.standard_normal((n, k)).astype(X)
    Aj = jsparse.csr_array(S)
    At = _port(Aj)
    Yt = At @ Xn
    assert At.spmm_path == route
    tol = 1e-6 if Yt.dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Aj @ Xn), rtol=tol,
                               atol=tol)


def test_dot_bsr_route_forced(bsr_forced):
    S = _random_csr(256, 256, 0.05, seed=23)
    Aj = jsparse.csr_array(S)
    At = _port(Aj)
    X = np.random.default_rng(24).standard_normal((256, 6)).astype(
        np.float32)
    Yt = At @ X
    assert At.spmm_path == "bsr"
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Aj @ X), rtol=1e-5,
                               atol=1e-5)
    # Past the BSR kernel's k the dispatch moves on, as the JAX one does.
    Xw = np.ones((256, tbsr.SPMM_MAX_K + 1), np.float32)
    At @ Xw
    assert At.spmm_path == "ell"


def test_dot_wide_x_takes_plain_dia(rng):
    S = _band(64, [-1, 0, 1], rng)
    At = tsparse.csr_array(S, device="cpu")
    X = rng.standard_normal((64, dia_kernel.SPMM_MAX_K + 1)).astype(
        np.float32)
    np.testing.assert_allclose((At @ X).numpy(), S @ X, rtol=1e-5,
                               atol=1e-5)
    assert At.spmm_path == "dia-torch"


def test_dot_out_and_column_vector(rng):
    S = _band(100, [-1, 0, 1], rng)
    At = tsparse.csr_array(S, device="cpu")
    X = rng.standard_normal((100, 3)).astype(np.float32)
    out = torch.empty((100, 3))
    assert At.dot(X, out=out) is out
    np.testing.assert_allclose(out.numpy(), S @ X, rtol=1e-6, atol=1e-6)
    y = At @ X[:, :1]
    assert tuple(y.shape) == (100, 1) and At.spmv_path == "dia-kernel"


def test_dia_array_and_linear_operator_matmat(rng):
    n = 200
    data = rng.standard_normal((3, n)).astype(np.float32)
    offsets = np.array([-2, 0, 5])
    Dj = jsparse.dia_array((data, offsets), shape=(n, n))
    Dt = interop.dia_from_parts(data, offsets, (n, n), device="cpu")
    X = rng.standard_normal((n, 4)).astype(np.float32)
    np.testing.assert_array_equal((Dt @ X).numpy(),
                                  np.asarray(Dj @ X).astype(np.float32))
    assert Dt.spmm_path == "dia-kernel"
    X64 = X.astype(np.float64)
    np.testing.assert_allclose((Dt @ X64).numpy(), np.asarray(Dj @ X64),
                               rtol=1e-12, atol=1e-12)
    assert Dt.spmm_path == "dia-torch"
    op = tlinalg.make_linear_operator(Dt.tocsr())
    np.testing.assert_allclose(op.matmat(torch.from_numpy(X)).numpy(),
                               np.asarray(Dj @ X), rtol=1e-6, atol=1e-6)
