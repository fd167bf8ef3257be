# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's BSR pack and SpMV against the JAX package's.

The pack is a numpy copy of ``legate_sparse_tpu.ops.bsr.bsr_pack`` and
must equal it exactly.  The SpMV runs the port's wrapper on CPU
tensors (its plain version) and the JAX ``BsrStructure.matvec`` in
interpret mode.  Tolerances: f32 at rtol = atol = 1e-5 (the two sum
each block's dot in another order); bf16 results at rtol = atol = 1e-2
(about two bf16 ulps: the f32 sums differ in order, then round to bf16).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from legate_sparse_tpu.ops import bsr as jbsr

from legate_sparse_tpu_torch.ops import bsr as tbsr

SHAPES = [(256, 256, 0.03), (300, 700, 0.02), (1000, 130, 0.05)]


def _random_csr(rows, cols, density, seed=0):
    rng = np.random.default_rng(seed)
    return sp.random(rows, cols, density=density, format="csr",
                     random_state=rng, dtype=np.float32)


@pytest.mark.parametrize("rows,cols,density", SHAPES)
def test_pack_equals_jax(rows, cols, density):
    A = _random_csr(rows, cols, density)
    pj = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    pt = tbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    assert pj is not None and pt is not None
    for a, b in zip(pj[:3], pt[:3]):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    assert tuple(pj[3:]) == tuple(pt[3:])


def test_pack_with_empty_block_rows_equals_jax():
    # Block-rows 1 and 3 hold no entry: each gets one zero block.
    A = sp.lil_array((512, 384), dtype=np.float32)
    A[5, 300] = 1.0
    A[260, 10] = 2.0
    A[261, 11] = 3.0
    A = A.tocsr()
    pj = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    pt = tbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    for a, b in zip(pj[:3], pt[:3]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert list(pt[1]) == [0, 1, 2, 3]


def test_pack_budget_declines_like_jax():
    A = _random_csr(512, 512, 0.001)
    assert jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, 1.0) is None
    assert tbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, 1.0) is None


@pytest.mark.parametrize("rows,cols,density", SHAPES)
def test_block_row_ptr(rows, cols, density):
    A = _random_csr(rows, cols, density, seed=4)
    _, brow, _, nbr, _ = tbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape,
                                       max_expand=1e9)
    bptr = tbsr.block_row_ptr(brow, nbr)
    assert bptr.dtype == np.int64 and bptr.shape == (nbr + 1,)
    for i in range(nbr):
        assert np.all(brow[bptr[i]:bptr[i + 1]] == i)
    assert bptr[-1] == len(brow)


@pytest.mark.parametrize("rows,cols,density", SHAPES)
def test_matvec_f32_matches_jax(rows, cols, density):
    A = _random_csr(rows, cols, density)
    pack = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    x = np.random.default_rng(1).standard_normal(cols).astype(np.float32)
    yj = np.asarray(jbsr.BsrStructure(*pack, rows, cols).matvec(
        x, interpret=True))
    st = tbsr.BsrStructure(*tbsr.bsr_pack(A.data, A.indices, A.indptr,
                                          A.shape, max_expand=1e9),
                           rows, cols, device="cpu")
    yt = st.matvec(torch.from_numpy(x))
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt.numpy(), A @ x, rtol=1e-5, atol=1e-5)


def test_matvec_bf16_matches_jax():
    rows, cols = 384, 384
    A = _random_csr(rows, cols, 0.04, seed=3)
    pack = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    x = np.random.default_rng(2).standard_normal(cols).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    yj = np.asarray(jbsr.BsrStructure(*pack, rows, cols, dtype=jnp.bfloat16)
                    .matvec(xb, interpret=True).astype(jnp.float32))
    st = tbsr.BsrStructure(*tbsr.bsr_pack(A.data, A.indices, A.indptr,
                                          A.shape, max_expand=1e9),
                           rows, cols, dtype=torch.bfloat16, device="cpu")
    yt = st.matvec(torch.from_numpy(np.array(xb.astype(jnp.float32))))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=1e-2, atol=1e-2)


def test_wrapper_rejects_bad_inputs():
    A = _random_csr(256, 256, 0.03)
    st = tbsr.BsrStructure(*tbsr.bsr_pack(A.data, A.indices, A.indptr,
                                          A.shape, max_expand=1e9),
                           256, 256, device="cpu")
    x2d = torch.zeros((2, 128), dtype=torch.float64)
    with pytest.raises(TypeError):
        tbsr.bsr_spmv(st.blkT, st.brow, st.bcol, st.bptr, x2d, st.nbr)
    with pytest.raises(ValueError):
        tbsr.bsr_spmv(st.blkT, st.brow, st.bcol, st.bptr,
                      torch.zeros((2, 64)), st.nbr)
    with pytest.raises(ValueError):
        tbsr.bsr_spmv(st.blkT, st.brow, st.bcol, st.bptr[:-1],
                      torch.zeros((2, 128)), st.nbr)
