# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's SpGEMM against the JAX package's.

The same matrices, made with numpy from a seed, go through both
packages; the port runs on ``device="cpu"``, where the banded SpGEMM
wrapper takes its plain version.  Tolerances:

- banded kernel, f32: the plain version equals the interpret-mode
  Pallas kernel (``pallas_dia_spgemm``) bit for bit: both add each
  output slot's products in ``offs_b`` order in f32 (the suite's
  ``--xla_backend_optimization_level=0`` keeps XLA:CPU from fusing a
  product into the next add as an FMA in the interpret run).  Against
  the XLA route ``dia_ops.dia_spgemm``, which adds in ``offs_a`` order,
  rtol = atol = 1e-6; with 33 products a slot ("nd33") the two orders
  part by more, so there each side is held to the bound of recursive
  summation, |Δ| <= 2 (terms - 1) 2^-24 Σ|a b|;
- banded kernel, bf16: a numpy emulation of the stated rule (product
  rounded to bf16, sum in f32) bit for bit; the interpret-mode kernel
  keeps the product exact in f32, so against it the bound is one bf16
  rounding per product and one of the result: |Δ| <= 2^-8 Σ|a b| +
  2^-8 |c|;
- ESC (single shot and chunked): pattern (``indices``, ``indptr``) bit
  for bit, values at rtol 1e-12 (f64) and 1e-6 (f32): the two sort
  equal keys in other orders, so duplicates add up in another order;
- ``transpose``, ``diagonal``, the COO constructor and ``band_to_csr``:
  bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import legate_sparse_tpu as jsparse
from legate_sparse_tpu.ops import dia_ops as jdia_ops
from legate_sparse_tpu.ops import pallas_dia
from legate_sparse_tpu.ops import spgemm as jspgemm

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import interop
from legate_sparse_tpu_torch.ops import dia_kernel
from legate_sparse_tpu_torch.ops import dia_ops as tdia_ops
from legate_sparse_tpu_torch.ops import spgemm as tspgemm

from test_torch_gpu import (SPGEMM_KERNEL_CASES, band_offsets, spgemm_case,
                            spgemm_expect_tiled, spgemm_offs_c,
                            spgemm_reach_case)


def _port(A_jax):
    return interop.csr_from_parts(np.asarray(A_jax.data),
                                  np.asarray(A_jax.indices),
                                  np.asarray(A_jax.indptr), A_jax.shape,
                                  device="cpu")


def _parts(A):
    if isinstance(A, tsparse.csr_array):
        return interop.to_numpy_parts(A)
    return (np.asarray(A.data).astype(np.float64), np.asarray(A.indices),
            np.asarray(A.indptr))


def _same_pattern(Cj, Ct):
    _, ij, pj = _parts(Cj)
    _, it, pt = _parts(Ct)
    np.testing.assert_array_equal(it.astype(np.int64), ij.astype(np.int64))
    np.testing.assert_array_equal(pt.astype(np.int64), pj.astype(np.int64))


def _exact_band(n, offsets, rng, m=None, dtype=np.float32):
    """Scipy band with every in-bounds slot explicit (no holes)."""
    m = n if m is None else m
    diags = []
    for _ in offsets:
        vals = rng.standard_normal(max(n, m)).astype(dtype)
        vals[vals == 0] = 1.0
        diags.append(vals)
    return sp.diags(diags, offsets, shape=(n, m), format="csr", dtype=dtype)


def _bands(A_sp, B_sp):
    Aj, Bj = jsparse.csr_array(A_sp), jsparse.csr_array(B_sp)
    da, db = Aj._get_dia(), Bj._get_dia()
    assert da[2] is None and db[2] is None
    offs_c = jdia_ops.band_product_offsets(da[1], db[1])
    return Aj, Bj, da, db, offs_c


def _jax_interpret(Aj, Bj, da, db, offs_c):
    tile = pallas_dia._spgemm_tile(db[1], len(da[1]), len(db[1]),
                                   len(offs_c), da[0].dtype)
    return np.asarray(pallas_dia.pallas_dia_spgemm(
        da[0], db[0], da[1], db[1], offs_c, Aj.shape, Bj.shape, tile,
        interpret=True).astype(jnp.float32))


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


# Small versions of the shapes where the CUDA kernel switches variants
# or meets its tiles' edges (``test_torch_gpu.SPGEMM_KERNEL_CASES``): n
# below one tile ("square-pm012", "rectangular") and not a multiple of
# it, an output diagonal with no valid pair, 9 and 33 diagonals, A's
# reach at the tiled variant's limit and one column past.
SPGEMM_CASES = {
    "square-pm012": (600, 600, 600, (-2, -1, 0, 1, 2), (-2, -1, 0, 1, 2)),
    "large-offsets": (3000, 3000, 3000, (-1100, 0, 7), (-5, 0, 1100)),
    "rectangular": (300, 400, 350, (-1, 0), (0, 2)),
    "n-not-tile-multiple": (2100, 2101, 2099, (-3, 0, 2), (-1, 0, 4)),
    "rect-empty-diag": SPGEMM_KERNEL_CASES["rect-empty-diag"],
    "nd9": (1500, 1500, 1500, band_offsets(9), band_offsets(9)),
    "nd33": (1200, 1200, 1200, band_offsets(33), band_offsets(33)),
    "reach-at-limit": spgemm_reach_case(torch.float32, False),
    "reach-past-limit": spgemm_reach_case(torch.float32, True),
}


@pytest.mark.parametrize("case", sorted(SPGEMM_CASES))
def test_dia_spgemm_plain_matches_interpret_kernel(case, rng):
    m, k, n, offs_a, offs_b = SPGEMM_CASES[case]
    A_sp = _exact_band(m, list(offs_a), rng, m=k)
    B_sp = _exact_band(k, list(offs_b), rng, m=n)
    Aj, Bj, da, db, offs_c = _bands(A_sp, B_sp)
    Cj = _jax_interpret(Aj, Bj, da, db, offs_c)
    Ct = dia_kernel.dia_spgemm(_to_torch(da[0]), _to_torch(db[0]), da[1],
                               db[1], offs_c, Aj.shape, Bj.shape)
    assert Ct.dtype == torch.float32
    np.testing.assert_array_equal(Ct.numpy(), Cj)
    Cx = np.asarray(jdia_ops.dia_spgemm(da[0], db[0], da[1], db[1], offs_c,
                                        Aj.shape, Bj.shape))
    pairs = dia_kernel.spgemm_pairs(da[1], db[1], offs_c, Aj.shape,
                                    Bj.shape)
    if max(map(len, pairs)) <= 9:
        np.testing.assert_allclose(Ct.numpy(), Cx, rtol=1e-6, atol=1e-6)
    else:
        # Up to 33 products a slot: the two summation orders each stay
        # within (terms - 1) 2^-24 sum |a b| of the exact sum.
        a, b = np.asarray(da[0]), np.asarray(db[0])
        mag = np.zeros_like(Cx)
        for ci, ps in enumerate(pairs):
            for a_i, b_i, ob, lo, hi in ps:
                mag[ci, lo:hi] += np.abs(a[a_i, lo - ob:hi - ob]
                                         * b[b_i, lo:hi])
        bound = 2 * (max(map(len, pairs)) - 1) * 2.0**-24 * mag
        assert np.all(np.abs(Ct.numpy() - Cx) <= bound)
    if case == "rect-empty-diag":
        empty = [ci for ci, ps in enumerate(pairs) if not ps]
        assert empty and not Ct[empty].any()


def test_dia_spgemm_aliased_operands_match_interpret_kernel(rng):
    """One tensor passed as A and B, as ``A @ A`` does."""
    A_sp = _exact_band(2000, [-2, -1, 0, 1, 2], rng)
    Aj, _, da, _, offs_c = _bands(A_sp, A_sp)
    a = _to_torch(da[0])
    Ct = dia_kernel.dia_spgemm(a, a, da[1], da[1], offs_c, Aj.shape,
                               Aj.shape)
    np.testing.assert_array_equal(
        Ct.numpy(), _jax_interpret(Aj, Aj, da, da, offs_c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_spgemm_variant_chooser(dtype):
    """The pde band at the chip shape takes the tiled variant; offsets
    past its reach, 33 diagonals in f32 (the staged bands pass 227 KB)
    and n at 2^30 take the general one, as do the GPU test cases."""
    def tiled(shape_a, shape_b, offs_a, offs_b):
        offs_c = spgemm_offs_c(offs_a, offs_b)
        pairs = dia_kernel.spgemm_pairs(offs_a, offs_b, offs_c, shape_a,
                                        shape_b)
        return dia_kernel.spgemm_tiled_ok(offs_a, offs_b, offs_c,
                                          sum(map(len, pairs)), shape_a,
                                          shape_b, dtype)

    n, pm2 = 1 << 24, (-2, -1, 0, 1, 2)
    assert tiled((n, n), (n, n), pm2, pm2)
    n2, far = 1 << 19, (1 << 17) + 3
    assert not tiled((n2, n2), (n2, n2), (-far, 0, 129), (-129, 0, far))
    big = 1 << 30
    assert not tiled((big, big), (big, big), pm2, pm2)
    assert tiled((big - 1, big - 1), (big - 1, big - 1), pm2, pm2)
    for case in sorted(SPGEMM_KERNEL_CASES) + ["reach-at-limit",
                                                 "reach-past-limit"]:
        m, k, n, offs_a, offs_b = spgemm_case(case, dtype)
        assert (tiled((m, k), (k, n), offs_a, offs_b)
                == spgemm_expect_tiled(case, dtype)), case
    # The reach limit is the shared-memory budget, to the byte.
    m, k, n, offs_a, offs_b = spgemm_case("reach-at-limit", dtype)
    smem = dia_kernel.spgemm_tiled_smem(
        2, 2, 4, 4, offs_b[1], dtype.itemsize)
    assert smem <= dia_kernel.SPGEMM_SMEM_MAX < dia_kernel.spgemm_tiled_smem(
        2, 2, 4, 4, offs_b[1] + 16 // dtype.itemsize, dtype.itemsize)


def test_dia_spgemm_bf16_product_rounded(rng):
    bf16 = jnp.bfloat16
    n = 700
    offs = (-3, -1, 0, 1, 3)
    A_sp = _exact_band(n, list(offs), rng)
    B_sp = _exact_band(n, [-2, 0, 2], rng)
    Aj, Bj, da, db, offs_c = _bands(A_sp, B_sp)
    a = np.asarray(jnp.asarray(da[0], bf16))
    b = np.asarray(jnp.asarray(db[0], bf16))
    Ct = dia_kernel.dia_spgemm(_to_torch(a.astype(np.float32),
                                         torch.bfloat16),
                               _to_torch(b.astype(np.float32),
                                         torch.bfloat16),
                               da[1], db[1], offs_c, Aj.shape, Bj.shape)
    assert Ct.dtype == torch.bfloat16
    Ct = Ct.float().numpy()

    af, bfl = a.astype(np.float32), b.astype(np.float32)
    acc = np.zeros((len(offs_c), n), np.float32)
    mag = np.zeros((len(offs_c), n), np.float32)
    for ci, pairs in enumerate(dia_kernel.spgemm_pairs(
            da[1], db[1], offs_c, Aj.shape, Bj.shape)):
        for a_i, b_i, ob, lo, hi in pairs:
            prod = af[a_i, lo - ob:hi - ob] * bfl[b_i, lo:hi]  # exact
            acc[ci, lo:hi] += prod.astype(bf16).astype(np.float32)
            mag[ci, lo:hi] += np.abs(prod)
    np.testing.assert_array_equal(Ct, acc.astype(bf16).astype(np.float32))

    Cj = np.asarray(pallas_dia.pallas_dia_spgemm(
        jnp.asarray(a), jnp.asarray(b), da[1], db[1], offs_c, Aj.shape,
        Bj.shape, pallas_dia._spgemm_tile(db[1], 5, 3, len(offs_c), bf16),
        interpret=True).astype(jnp.float32))
    assert np.all(np.abs(Ct - Cj) <= 2.0**-8 * (mag + np.abs(Cj)))


def test_dia_spgemm_declines_mixed_dtypes():
    a = torch.zeros((1, 4), dtype=torch.float32)
    assert not dia_kernel.spgemm_supported(a, a.to(torch.bfloat16))
    assert not dia_kernel.spgemm_supported(a.double(), a.double())
    with pytest.raises(TypeError):
        dia_kernel.dia_spgemm(a, a.double(), (0,), (0,), (0,), (4, 4),
                              (4, 4))


@pytest.mark.parametrize("offs", [((-1,), (1,)), ((-2, 0), (0, 3)),
                                  ((-1, 0, 1), (-1, 0, 1)), ((2,), (-2,))])
@pytest.mark.parametrize("shape", [(20, 20, 20), (15, 22, 18)])
def test_band_product_predicates_match_jax(offs, shape):
    offs_a, offs_b = offs
    m, k, n = shape
    offs_c = jdia_ops.band_product_offsets(offs_a, offs_b)
    assert tdia_ops.band_product_offsets(offs_a, offs_b) == offs_c
    assert (tdia_ops.band_product_is_full(offs_a, offs_b, offs_c, (m, k),
                                          (k, n))
            == jdia_ops.band_product_is_full(offs_a, offs_b, offs_c, (m, k),
                                             (k, n)))


@pytest.mark.parametrize("shape", [(40, 40), (30, 50), (50, 30)])
@pytest.mark.parametrize("offsets", [(-3, 0, 1), (-45, 0, 45), (-1, 2)])
def test_band_to_csr_bitwise(shape, offsets, rng):
    rows, cols = shape
    offs = tuple(o for o in offsets if -rows < o < cols)
    data = rng.standard_normal((len(offs), cols))
    data[0, 3] = 0.0                       # an explicit zero is kept
    nnz = tdia_ops.band_cover(offs, shape, cols)
    vj, cj, pj = jdia_ops.band_to_csr(jnp.asarray(data), offs, shape, nnz)
    vt, ct, pt = tdia_ops.band_to_csr(torch.from_numpy(data), offs, shape,
                                      nnz)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def _random_pair(m, k, n, rng, dtype, density=0.05):
    A = sp.random(m, k, density=density, format="csr", random_state=rng,
                  dtype=dtype)
    B = sp.random(k, n, density=density, format="csr", random_state=rng,
                  dtype=dtype)
    return A, B


@pytest.mark.parametrize("dtype,chunked,shape", [
    (np.float64, False, (120, 80, 150)), (np.float64, True, (120, 80, 150)),
    (np.float32, False, (64, 64, 64)), (np.float32, True, (64, 64, 64))])
def test_esc_matches_jax(dtype, chunked, shape, rng):
    m, k, n = shape
    A_sp, B_sp = _random_pair(m, k, n, rng, dtype, density=0.08)
    Aj, Bj = jsparse.csr_array(A_sp), jsparse.csr_array(B_sp)
    At, Bt = _port(Aj), _port(Bj)
    # About three chunks: each fold of the JAX package's chunked mode
    # compiles anew, so many small chunks only cost time.
    T = int(np.diff(B_sp.indptr)[A_sp.indices].sum())
    chunk = T // 3 + 1 if chunked else None
    outj = jspgemm.spgemm_csr_csr_csr_impl(
        Aj.data, Aj.indices, Aj.indptr, Bj.data, Bj.indices, Bj.indptr,
        m, k, n, chunk_products=chunk)
    chunks_j = jspgemm._last_num_chunks
    *outt, chunks_t = tspgemm.spgemm_csr_csr_csr_impl(
        At.data, At.indices, At.indptr, Bt.data, Bt.indices, Bt.indptr,
        m, k, n, chunk_products=chunk)
    assert chunks_t == chunks_j
    if chunked:
        assert chunks_j > 1
    np.testing.assert_array_equal(outt[1].numpy().astype(np.int64),
                                  np.asarray(outj[1]).astype(np.int64))
    np.testing.assert_array_equal(outt[2].numpy(), np.asarray(outj[2]))
    tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(outt[0].numpy(), np.asarray(outj[0]),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        sp.csr_array((outt[0].numpy(), outt[1].numpy(), outt[2].numpy()),
                     shape=(m, n)).toarray(),
        (A_sp @ B_sp).toarray(), rtol=10 * tol, atol=10 * tol)


def test_esc_empty_product(rng):
    A_sp = sp.random(30, 20, density=0.1, format="csr", random_state=rng)
    A_sp[:, 5:] = 0.0
    A_sp.eliminate_zeros()
    B_sp = sp.random(20, 25, density=0.1, format="csr", random_state=rng)
    B_sp[:5, :] = 0.0
    B_sp.eliminate_zeros()
    Aj, Bj = jsparse.csr_array(A_sp), jsparse.csr_array(B_sp)
    Cj = Aj @ Bj
    Ct = _port(Aj) @ _port(Bj)
    assert Ct.nnz == Cj.nnz == 0 and Ct.shape == (30, 25)
    _same_pattern(Cj, Ct)
    assert Ct.dtype == torch.float64


def test_dot_routes_match_jax(rng):
    """csr dot: exact f32 bands take the banded kernel, f64 bands the
    plain banded route, a holey band and an irregular pair take ESC;
    every route gives the JAX package's pattern and its values."""
    band = _exact_band(400, [-2, -1, 0, 1, 2], rng)
    for A_sp, B_sp, path, tol in (
            (band, band, "dia-kernel", 1e-6),
            (band.astype(np.float64), band.astype(np.float64), "dia-torch",
             1e-12),
            (tsparse_poisson(12), tsparse_poisson(12), "esc", 1e-12),
            (*_random_pair(90, 70, 60, rng, np.float64), "esc", 1e-12)):
        Aj, Bj = jsparse.csr_array(A_sp), jsparse.csr_array(B_sp)
        Cj = Aj @ Bj
        At = _port(Aj)
        Ct = At @ _port(Bj)
        assert At.spgemm_path == path
        _same_pattern(Cj, Ct)
        np.testing.assert_allclose(_parts(Ct)[0], _parts(Cj)[0], rtol=tol,
                                   atol=tol)
        if path.startswith("dia"):
            assert Ct._dia is not None and Ct._dia[2] is None


def tsparse_poisson(N):
    from legate_sparse_tpu_torch.apps import gmg

    return gmg.poisson2D(N, device="cpu").toscipy()


def test_bf16_holey_band_takes_banded_route_in_both(rng):
    """bf16 storage drops the hole mask in both packages, so a holey
    band takes the banded product and keeps every band slot: the
    patterns agree; values within two bf16 roundings of the product's
    magnitude."""
    S = tsparse_poisson(10).astype(np.float32)
    Aj = jsparse.csr_array(S).astype(jnp.bfloat16)
    assert Aj._get_dia()[2] is None
    Cj = Aj @ Aj
    At = _port(Aj)
    assert At.dtype == torch.bfloat16
    Ct = At @ At
    assert At.spgemm_path == "dia-kernel" and Ct.dtype == torch.bfloat16
    _same_pattern(Cj, Ct)
    mag = (abs(S) @ abs(S)).toarray()
    diff = np.abs(Ct.toscipy().toarray() - np.asarray(Cj.todense(),
                                                      np.float32))
    assert np.all(diff <= 2.0**-7 * mag)


def test_dot_scipy_and_dia_operands(rng):
    S = sp.random(50, 40, density=0.1, format="csr", random_state=rng)
    T = sp.random(40, 30, density=0.1, format="csr", random_state=rng)
    At = tsparse.csr_array(S, device="cpu")
    C = At @ T
    assert At.spgemm_path == "esc"
    np.testing.assert_allclose(C.toscipy().toarray(), (S @ T).toarray(),
                               rtol=1e-12, atol=1e-12)
    D = tsparse.diags([1.0, 2.0, 3.0], [-1, 0, 1], shape=(40, 40),
                      device="cpu")
    np.testing.assert_allclose((At @ D).toscipy().toarray(),
                               (S @ D.toscipy()).toarray(), rtol=1e-12)
    np.testing.assert_allclose((D @ T).toscipy().toarray(),
                               (D.toscipy() @ T).toarray(), rtol=1e-12)
    with pytest.raises(ValueError):
        At.dot(T, out=np.zeros((50, 30)))
    with pytest.raises(ValueError):
        At @ tsparse.csr_array(S, device="cpu")


def test_transpose_bitwise(rng):
    S = sp.random(70, 45, density=0.1, format="csr", random_state=rng)
    Aj = jsparse.csr_array(S)
    At = _port(Aj)
    Tj, Tt = Aj.T, At.T
    assert Tt.shape == (45, 70)
    np.testing.assert_array_equal(_parts(Tt)[0], _parts(Tj)[0])
    _same_pattern(Tj, Tt)


@pytest.mark.parametrize("k", [-3, 0, 2])
def test_diagonal_bitwise(k, rng):
    S = sp.random(40, 50, density=0.2, format="csr", random_state=rng)
    Aj = jsparse.csr_array(S)
    np.testing.assert_array_equal(_port(Aj).diagonal(k).numpy(),
                                  np.asarray(Aj.diagonal(k)))


def test_coo_constructor_bitwise(rng):
    rows = rng.integers(0, 30, 200)
    cols = rng.integers(0, 25, 200)           # duplicates and any order
    vals = rng.standard_normal(200)
    Aj = jsparse.csr_array((vals, (rows, cols)), shape=(32, 25))
    At = tsparse.csr_array((vals, (rows, cols)), shape=(32, 25),
                           device="cpu")
    np.testing.assert_array_equal(_parts(At)[0], _parts(Aj)[0])
    _same_pattern(Aj, At)
    Bj = jsparse.csr_array((vals, (rows, cols)))
    Bt = tsparse.csr_array((vals, (rows, cols)), device="cpu")
    assert Bt.shape == tuple(Bj.shape)
    E = tsparse.csr_array((4, 6), device="cpu")
    assert E.shape == (4, 6) and E.nnz == 0 and E.dtype == torch.float64
    assert tuple(E.indptr.tolist()) == (0,) * 5
