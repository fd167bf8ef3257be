# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's banded SpMV against the JAX package's Pallas DIA kernel.

The same matrices and vectors, made with numpy from a seed, go through
``legate_sparse_tpu.ops.pallas_dia.pallas_dia_spmv`` in interpret mode
(reached as ``tests/test_pallas_dia.py`` reaches it) and through the
port's ``dia_kernel.dia_spmv`` on CPU tensors, which runs the kernel's
plain version.  Tolerances: f32 at rtol = atol = 1e-6; bf16 bit for
bit (both take the product in bf16 and add in f32 in offset order).
"""

import numpy as np
import pytest
import scipy.sparse as scsp
import torch

import jax.numpy as jnp

import legate_sparse_tpu as jsparse
from legate_sparse_tpu.ops import pallas_dia

from legate_sparse_tpu_torch import interop
from legate_sparse_tpu_torch.ops import dia_kernel


def _banded(n, offsets, rng, m=None, dtype=np.float32):
    m = n if m is None else m
    diags = [rng.standard_normal(max(n, m)).astype(dtype) for _ in offsets]
    return scsp.diags(diags, offsets, shape=(n, m), format="csr",
                      dtype=dtype)


def _holey(n, rng, every=7):
    main = rng.standard_normal(n).astype(np.float32)
    off1 = rng.standard_normal(n - 1).astype(np.float32)
    off1[::every] = 0.0
    A = scsp.diags([main, off1, off1], [0, 1, -1], format="csr")
    A.eliminate_zeros()
    return A


def _jax_matrix(A_sp, dtype=None):
    A = jsparse.csr_array(A_sp)
    return A.astype(dtype) if dtype is not None else A


def _jax_pack(A):
    dia_data, offsets, mask = A._get_dia()
    packed = pallas_dia.pack_band(dia_data, offsets, A.shape, mask=mask)
    assert packed is not None
    return packed


def _jax_spmv(A, x):
    packed = _jax_pack(A)
    return np.asarray(pallas_dia.pallas_dia_spmv(
        packed.rdata, packed.rmask, jnp.asarray(x), packed.offsets,
        packed.shape, packed.tile, interpret=True,
    ).astype(jnp.float32))


def _port_matrix(A_jax):
    return interop.csr_from_parts(np.asarray(A_jax.data),
                                  np.asarray(A_jax.indices),
                                  np.asarray(A_jax.indptr), A_jax.shape,
                                  device="cpu")


def _port_spmv(A, x):
    packed = A._get_dia_pack()
    assert packed is not None
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(packed.rdata.dtype)
    return dia_kernel.dia_spmv(packed, xt).float().numpy()


def _both(A_sp, x):
    Aj = _jax_matrix(A_sp)
    return _jax_spmv(Aj, x), _port_spmv(_port_matrix(Aj), x)


@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-5, -1, 0, 1, 5), (0,),
                                     (-37, 2)])
def test_exact_band(n, offsets, rng):
    A_sp = _banded(n, list(offsets), rng)
    x = rng.standard_normal(n).astype(np.float32)
    yj, yt = _both(A_sp, x)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_holey_band(rng):
    A_sp = _holey(600, rng)
    Aj = _jax_matrix(A_sp)
    assert Aj._get_dia()[2] is not None, "expect a holey band"
    x = rng.standard_normal(600).astype(np.float32)
    np.testing.assert_allclose(_port_spmv(_port_matrix(Aj), x),
                               _jax_spmv(Aj, x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(200, 300), (300, 200)])
def test_rectangular(shape, rng):
    n, m = shape
    A_sp = _banded(n, [-2, 0, 3], rng, m=m)
    x = rng.standard_normal(m).astype(np.float32)
    yj, yt = _both(A_sp, x)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_offsets_beyond_128(rng):
    n = 4096
    offsets = [-1030, -129, -128, -127, 0, 127, 128, 129, 1030]
    A_sp = _banded(n, offsets, rng)
    x = rng.standard_normal(n).astype(np.float32)
    yj, yt = _both(A_sp, x)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_nonfinite_x_at_holes_and_out_of_range(rng):
    n = 256
    main = np.ones(n, np.float32)
    off1 = np.ones(n - 1, np.float32)
    off1[10] = 0.0                       # hole at (10, 11)
    A_sp = scsp.diags([main, off1], [0, 1], format="csr")
    A_sp.eliminate_zeros()
    x = np.ones(n, np.float32)
    x[11] = np.inf
    yj, yt = _both(A_sp, x)
    assert np.isfinite(yt[10]) and yt[10] == yj[10]
    np.testing.assert_array_equal(np.isinf(yt), np.isinf(yj))
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    # x entries past the last row's reach are never read.
    B_sp = _holey(300, rng)
    xb = rng.standard_normal(300).astype(np.float32)
    Bj = _jax_matrix(B_sp)
    mask = np.asarray(Bj._get_dia()[2])
    hole_cols = np.nonzero(~mask[2, :300])[0]          # offset +1 holes
    hole_cols = hole_cols[hole_cols > 0]
    xb[hole_cols[:5]] = np.nan
    yj, yt = _jax_spmv(Bj, xb), _port_spmv(_port_matrix(Bj), xb)
    np.testing.assert_array_equal(np.isnan(yt), np.isnan(yj))
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_bf16_product_rounded(rng):
    """bf16: the port rounds each product to bf16 and adds in f32 in
    offset order (``pallas_dia.py:304``'s stated arithmetic).  It equals
    a numpy emulation of that bit for bit.  The JAX kernel in interpret
    mode on the CPU keeps the product exact in f32 (XLA drops the bf16
    round trip), so against it the bound is one bf16 rounding per
    product plus one of the result: |Δ| <= 2^-8·Σ|a·x| + 2^-8·|y|."""
    bf16 = jnp.bfloat16
    n = 1000
    A_sp = _banded(n, [-3, -1, 0, 1, 3], rng)
    Aj = _jax_matrix(A_sp, bf16)
    x = rng.standard_normal(n).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, bf16))
    At = _port_matrix(Aj)
    assert At.dtype == torch.bfloat16
    packed = At._get_dia_pack()
    yt = dia_kernel.dia_spmv(
        packed, torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    yt = yt.float().numpy()

    rdata = packed.rdata.float().numpy()
    xf = xb.astype(np.float32)
    acc = np.zeros(n, np.float32)
    mag = np.zeros(n, np.float32)
    for d, off in enumerate(packed.offsets):
        xs = np.zeros(n, np.float32)
        lo, hi = max(0, -off), min(n, n - off)
        xs[lo:hi] = xf[lo + off:hi + off]
        prod = rdata[d] * xs                      # exact in f32
        acc = acc + prod.astype(bf16).astype(np.float32)
        mag += np.abs(prod)
    np.testing.assert_array_equal(yt, acc.astype(bf16).astype(np.float32))

    yj = _jax_spmv(Aj, xb)
    assert np.all(np.abs(yt - yj) <= 2.0**-8 * (mag + np.abs(yj)))


@pytest.mark.parametrize("holey", [False, True])
def test_row_align_matches_jax_pack(holey, rng):
    A_sp = _holey(700, rng) if holey else _banded(700, [-129, 0, 4], rng)
    Aj = _jax_matrix(A_sp)
    pj = _jax_pack(Aj)
    pt = _port_matrix(Aj)._get_dia_pack()
    rows = Aj.shape[0]
    nd = len(pj.offsets)
    assert pt.offsets == tuple(pj.offsets)
    np.testing.assert_array_equal(
        pt.rdata.numpy(), np.asarray(pj.rdata).reshape(nd, -1)[:, :rows])
    if holey:
        np.testing.assert_array_equal(
            pt.rmask.numpy(), np.asarray(pj.rmask).reshape(nd, -1)[:, :rows])
    else:
        assert pt.rmask is None and pj.rmask is None


def test_csr_dot_takes_kernel_path(rng):
    A_sp = _holey(500, rng)
    Aj = _jax_matrix(A_sp)
    At = _port_matrix(Aj)
    x = rng.standard_normal(500).astype(np.float32)
    y = At @ x
    assert At.spmv_path == "dia-kernel"
    np.testing.assert_allclose(y.numpy(), np.asarray(Aj @ x), rtol=1e-6,
                               atol=1e-6)


def test_dia_array_dot_matches_jax(rng):
    n = 300
    data = rng.standard_normal((3, n)).astype(np.float32)
    offsets = np.array([-2, 0, 5])
    Dj = jsparse.dia_array((data, offsets), shape=(n, n))
    Dt = interop.dia_from_parts(data, offsets, (n, n), device="cpu")
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose((Dt @ x).numpy(), np.asarray(Dj @ x),
                               rtol=1e-6, atol=1e-6)
    assert Dt.spmv_path == "dia-kernel"
    x64 = x.astype(np.float64)
    np.testing.assert_allclose((Dt @ x64).numpy(), np.asarray(Dj @ x64),
                               rtol=1e-12, atol=1e-12)
    assert Dt.spmv_path == "dia-torch"


def test_wrapper_rejects_bad_inputs(rng):
    At = _port_matrix(_jax_matrix(_banded(64, [0, 1], rng)))
    packed = At._get_dia_pack()
    with pytest.raises(ValueError):
        dia_kernel.dia_spmv(packed, torch.zeros(63))
    with pytest.raises(TypeError):
        dia_kernel.dia_spmv(packed, torch.zeros(64, dtype=torch.float64))
    assert dia_kernel.pack_band(torch.zeros((2, 8), dtype=torch.float64),
                                (0, 1), (8, 8)) is None
