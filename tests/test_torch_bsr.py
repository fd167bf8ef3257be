# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's BSR structure and SpMV against the JAX package's.

The port builds the present-block list from the matrix's own tensors
(``build_structure``); its ``brow``/``bcol``/``nbr``/``nbc`` must equal
the JAX ``bsr_pack``'s exactly, and the plain versions' densified blocks
(``densify``) its ``blkT`` bit for bit.  The SpMV runs the port's wrapper
on CPU tensors (its plain version) and the JAX ``BsrStructure.matvec``
in interpret mode.  Tolerances: f32 at rtol = atol = 1e-5 (the two sum
each block's dot in another order); bf16 results at rtol = atol = 1e-2
(about two bf16 ulps: the f32 sums differ in order, then round to bf16).
With inf/NaN in x the NaN/inf pattern must be equal exactly (zero slots
of a present block multiply x), and the finite values within 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from legate_sparse_tpu.ops import bsr as jbsr

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import csr as tcsr
from legate_sparse_tpu_torch import utils as tutils
from legate_sparse_tpu_torch.ops import bsr as tbsr
from legate_sparse_tpu_torch.ops.convert import row_ids_from_indptr
from legate_sparse_tpu_torch.settings import settings as tsettings

from test_torch_gpu import (assert_same_nonfinite, many_blocks_case,
                            nonfinite_case)

SHAPES = [(256, 256, 0.03), (300, 700, 0.02), (1000, 130, 0.05)]


def _random_csr(rows, cols, density, seed=0):
    rng = np.random.default_rng(seed)
    return sp.random(rows, cols, density=density, format="csr",
                     random_state=rng, dtype=np.float32)


def _structure(A, dtype=torch.float32, max_expand=1e9,
               index_dtype=torch.int32):
    data = torch.from_numpy(A.data).to(dtype)
    indices = torch.from_numpy(A.indices).to(index_dtype)
    indptr = torch.from_numpy(A.indptr.astype(np.int64))
    return tbsr.build_structure(data, indices, indptr,
                                row_ids_from_indptr(indptr, A.nnz), A.shape,
                                max_expand)


def _assert_equals_jax_pack(A, st, pj):
    """``st`` holds the JAX pack's block list, and its densified blocks
    equal the JAX pack's ``blkT`` bit for bit."""
    blkT, brow, bcol, nbr, nbc = pj
    np.testing.assert_array_equal(st.brow.numpy(), np.asarray(brow))
    np.testing.assert_array_equal(st.bcol.numpy(), np.asarray(bcol))
    assert st.brow.dtype == torch.int32 and st.bcol.dtype == torch.int32
    assert (st.nbr, st.nbc) == (nbr, nbc)
    dense = tbsr.densify(st)
    assert dense.dtype == torch.float32
    np.testing.assert_array_equal(dense.numpy().view(np.uint32),
                                  np.asarray(blkT).view(np.uint32))


@pytest.mark.parametrize("rows,cols,density", SHAPES)
def test_pack_equals_jax(rows, cols, density):
    A = _random_csr(rows, cols, density)
    pj = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    st = _structure(A)
    assert pj is not None and st is not None
    _assert_equals_jax_pack(A, st, pj)
    # The structure adds the block list only; the CSR tensors are shared.
    assert st.extra_bytes == st.nblocks * 8 + (st.nbr + 1) * 8
    assert not any(t.dim() == 3 for t in vars(st).values()
                   if isinstance(t, torch.Tensor))


def test_pack_bf16_equals_jax():
    """A bf16 matrix: the densified blocks equal the JAX structure's
    bf16 blocks, widened."""
    A = _random_csr(384, 300, 0.04, seed=7)
    pj = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    blk_bf16 = np.asarray(jbsr.BsrStructure(*pj, *A.shape,
                                            dtype=jnp.bfloat16)
                          .blkT.astype(jnp.float32))
    st = _structure(A, dtype=torch.bfloat16)
    assert st.dtype == torch.bfloat16
    np.testing.assert_array_equal(tbsr.densify(st).numpy().view(np.uint32),
                                  blk_bf16.view(np.uint32))


def test_pack_with_empty_block_rows_equals_jax():
    # Block-rows 1 and 3 hold no entry: each gets one zero block.
    A = sp.lil_array((512, 384), dtype=np.float32)
    A[5, 300] = 1.0
    A[260, 10] = 2.0
    A[261, 11] = 3.0
    A = A.tocsr()
    pj = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    st = _structure(A)
    _assert_equals_jax_pack(A, st, pj)
    assert st.brow.tolist() == [0, 1, 2, 3]


def test_pack_int64_indices_equals_jax():
    A = _random_csr(300, 700, 0.02, seed=8)
    pj = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    st = _structure(A, index_dtype=torch.int64)
    assert st.indices.dtype == torch.int64
    _assert_equals_jax_pack(A, st, pj)


def test_pack_budget_declines_like_jax():
    A = _random_csr(512, 512, 0.001)
    assert jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, 1.0) is None
    assert _structure(A, max_expand=1.0) is None


@pytest.mark.parametrize("rows,cols,density", SHAPES)
def test_block_row_ptr(rows, cols, density):
    A = _random_csr(rows, cols, density, seed=4)
    st = _structure(A)
    bptr, brow = st.bptr.numpy(), st.brow.numpy()
    assert bptr.dtype == np.int64 and bptr.shape == (st.nbr + 1,)
    for i in range(st.nbr):
        assert bptr[i + 1] > bptr[i]          # every block-row has a block
        assert np.all(brow[bptr[i]:bptr[i + 1]] == i)
    assert bptr[-1] == len(brow)


def _jax_matvec(A, x, dtype=jnp.float32):
    pack = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape, max_expand=1e9)
    return np.asarray(jbsr.BsrStructure(*pack, *A.shape, dtype=dtype)
                      .matvec(jnp.asarray(x, dtype), interpret=True)
                      .astype(jnp.float32))


@pytest.mark.parametrize("rows,cols,density", SHAPES)
def test_matvec_f32_matches_jax(rows, cols, density):
    A = _random_csr(rows, cols, density)
    x = np.random.default_rng(1).standard_normal(cols).astype(np.float32)
    yj = _jax_matvec(A, x)
    yt = _structure(A).matvec(torch.from_numpy(x))
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt.numpy(), A @ x, rtol=1e-5, atol=1e-5)


def test_matvec_bf16_matches_jax():
    rows, cols = 384, 384
    A = _random_csr(rows, cols, 0.04, seed=3)
    x = np.random.default_rng(2).standard_normal(cols).astype(np.float32)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    yj = _jax_matvec(A, xb, jnp.bfloat16)
    yt = _structure(A, dtype=torch.bfloat16).matvec(torch.from_numpy(xb))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=1e-2, atol=1e-2)


def test_matvec_nonfinite_matches_jax_kernel():
    A, x = nonfinite_case()
    yj = _jax_matvec(A, x)
    yt = _structure(A).matvec(torch.from_numpy(x)).numpy()
    assert np.isnan(yj).any() and np.isinf(yj).any() and np.isfinite(yj).any()
    assert_same_nonfinite(yt, yj)


def test_many_blocks_and_long_row_match_jax_and_scipy():
    A = many_blocks_case()
    st = _structure(A)
    counts = np.diff(st.bptr.numpy())
    assert counts.max() > 16 and st.brow.tolist().count(1) == 1
    x = np.random.default_rng(11).standard_normal(A.shape[1]).astype(
        np.float32)
    yt = st.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, _jax_matvec(A, x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt, A.astype(np.float64) @ x, rtol=1e-5,
                               atol=1e-5)


def test_get_bsr_builds_without_numpy(monkeypatch):
    """``csr_array._get_bsr`` builds from the tensors, with no round trip
    through numpy."""
    A = _random_csr(300, 700, 0.02, seed=12)
    At = tsparse.csr_array(A, device="cpu")

    def no_numpy(*args, **kwargs):
        raise AssertionError("to_numpy called while building BSR")

    monkeypatch.setattr(tcsr, "to_numpy", no_numpy)
    monkeypatch.setattr(tutils, "to_numpy", no_numpy)
    monkeypatch.setattr(torch.Tensor, "numpy", no_numpy)
    monkeypatch.setattr(tsettings, "bsr_force", True)
    st = At._get_bsr()
    monkeypatch.undo()
    assert st is not None and st.data is At.data and st.indices is At.indices
    pj = jbsr.bsr_pack(A.data, A.indices, A.indptr, A.shape,
                       max_expand=tsettings.bsr_max_expand)
    _assert_equals_jax_pack(A, st, pj)


def test_wrapper_rejects_bad_inputs():
    A = _random_csr(256, 256, 0.03)
    st = _structure(A)
    x2d = torch.zeros((2, 128), dtype=torch.float64)
    with pytest.raises(TypeError):
        tbsr.bsr_spmv(st, x2d)
    with pytest.raises(ValueError):
        tbsr.bsr_spmv(st, torch.zeros((2, 64)))
    st.bptr = st.bptr[:-1]
    with pytest.raises(ValueError):
        tbsr.bsr_spmv(st, torch.zeros((2, 128)))
