# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside
the test).  This file imports neither ``jax`` nor the JAX package, so
it also runs on a machine that has only PyTorch, without the suite's
``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: the DIA SpMV, SpMM and SpGEMM kernels repeat their plain
versions' arithmetic in the same order, so each pair agrees bit for bit
(f32 and bf16); the BSR SpMV and SpMM kernels sum each block's 128-term
dot in another order, so rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu_torch as sparse
from legate_sparse_tpu_torch.ops import bsr as bsr_ops
from legate_sparse_tpu_torch.ops import dia_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _holey(n, rng, every=7):
    off1 = rng.standard_normal(n - 1).astype(np.float32)
    off1[::every] = 0.0
    return sp.diags([rng.standard_normal(n).astype(np.float32), off1, off1],
                    [0, 1, -1], format="csr")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    S = _holey(100_000, rng)
    S.eliminate_zeros()
    A = sparse.csr_array(S, dtype=dtype, device=cuda)
    packed = A._get_dia_pack()
    assert packed is not None
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    x = x.to(cuda, dtype)
    before = dia_kernel.dia_spmv.launches
    y = dia_kernel.dia_spmv(packed, x)
    assert dia_kernel.dia_spmv.launches == before + 1
    yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, x,
                                   packed.offsets, packed.shape)
    torch.cuda.synchronize()
    assert torch.equal(y, yp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(5)
    S = sp.random(4096, 4096, density=0.002, format="csr", random_state=rng,
                  dtype=np.float32)
    st = bsr_ops.BsrStructure(*bsr_ops.bsr_pack(S.data, S.indices, S.indptr,
                                                S.shape, max_expand=1e9),
                              4096, 4096, dtype=dtype, device=cuda)
    x2d = torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32))
    x2d = x2d.to(cuda, dtype)
    before = bsr_ops.bsr_spmv.launches
    y = bsr_ops.bsr_spmv(st.blkT, st.brow, st.bcol, st.bptr, x2d, st.nbr)
    assert bsr_ops.bsr_spmv.launches == before + 1
    yp = bsr_ops.bsr_spmv_plain(st.blkT, st.brow, st.bcol, x2d, st.nbr)
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_csr_dot_dispatch_on_card(cuda):
    """On the card a banded f32 matrix takes the DIA kernel and an
    irregular one within the BSR budget takes the BSR kernel."""
    rng = np.random.default_rng(1)
    S = _holey(5000, rng)
    A = sparse.csr_array(S, device=cuda)
    x = rng.standard_normal(5000).astype(np.float32)
    y = A @ x
    assert A.spmv_path == "dia-kernel"
    np.testing.assert_allclose(y.cpu().numpy(), S @ x, rtol=1e-5, atol=1e-5)
    R = sp.random(2048, 2048, density=0.01, format="csr", random_state=rng,
                  dtype=np.float32)
    B = sparse.csr_array(R, device=cuda)
    xr = rng.standard_normal(2048).astype(np.float32)
    y = B @ xr
    assert B.spmv_path == "bsr"
    np.testing.assert_allclose(y.cpu().numpy(), R @ xr, rtol=1e-4, atol=1e-4)


def _cuda_band(n, offsets, rng, dtype, cuda, holes=False):
    diags = [rng.standard_normal(n).astype(np.float32) for _ in offsets]
    if holes:
        for d in diags:
            d[::7] = 0.0
    S = sp.diags(diags, offsets, shape=(n, n), format="csr")
    S.eliminate_zeros()
    return sparse.csr_array(S, dtype=dtype, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 7, 16, 33])
def test_dia_spmm_kernel_matches_plain(cuda, dtype, k):
    rng = np.random.default_rng(2)
    n = 20_000
    A = _cuda_band(n, [-3, -1, 0, 1, 3], rng, dtype, cuda, holes=True)
    packed = A._get_dia_pack()
    assert packed is not None
    X = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    X = X.to(cuda, dtype)
    if dtype == torch.float32:
        # Non-finite X rows that only holes reach must not reach Y.
        hole_cols = np.nonzero(packed.rmask[2].cpu().numpy() == 0)[0][:20]
        X[torch.as_tensor(hole_cols, device=cuda)] = float("inf")
    before = dia_kernel.dia_spmm.launches
    Y = dia_kernel.dia_spmm(packed, X)
    assert dia_kernel.dia_spmm.launches == before + 1
    Yp = dia_kernel.dia_spmm_plain(packed.rdata, packed.rmask, X,
                                   packed.offsets, packed.shape)
    torch.cuda.synchronize()
    assert torch.equal(Y, Yp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_bsr_spmm_kernel_matches_plain(cuda, dtype, k):
    rng = np.random.default_rng(6)
    S = sp.random(4096, 3000, density=0.002, format="csr", random_state=rng,
                  dtype=np.float32)
    st = bsr_ops.BsrStructure(*bsr_ops.bsr_pack(S.data, S.indices, S.indptr,
                                                S.shape, max_expand=1e9),
                              4096, 3000, dtype=dtype, device=cuda)
    X = torch.from_numpy(rng.standard_normal((st.nbc * 128, k))
                         .astype(np.float32)).to(cuda, dtype)
    before = bsr_ops.bsr_spmm.launches
    Y = bsr_ops.bsr_spmm(st.blkT, st.brow, st.bcol, st.bptr, X, st.nbr)
    assert bsr_ops.bsr_spmm.launches == before + 1
    Yp = bsr_ops.bsr_spmm_plain(st.blkT, st.brow, st.bcol, X, st.nbr)
    torch.testing.assert_close(Y, Yp, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offs", [((-2, -1, 0, 1, 2), (-2, -1, 0, 1, 2)),
                                  ((-300, 0, 7), (-5, 0, 299))])
def test_dia_spgemm_kernel_matches_plain(cuda, dtype, offs):
    rng = np.random.default_rng(3)
    m, k, n = 5000, 4000, 4500
    offs_a, offs_b = offs
    offs_c = tuple(sorted({a + b for a in offs_a for b in offs_b}))
    a = torch.from_numpy(rng.standard_normal((len(offs_a), k))
                         .astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((len(offs_b), n))
                         .astype(np.float32)).to(cuda, dtype)
    before = dia_kernel.dia_spgemm.launches
    C = dia_kernel.dia_spgemm(a, b, offs_a, offs_b, offs_c, (m, k), (k, n))
    assert dia_kernel.dia_spgemm.launches == before + 1
    Cp = dia_kernel.dia_spgemm_plain(a, b, offs_a, offs_b, offs_c, (m, k),
                                     (k, n))
    torch.cuda.synchronize()
    assert C.dtype == dtype and torch.equal(C, Cp)
