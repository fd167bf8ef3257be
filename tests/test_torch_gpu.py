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
(f32 and bf16), in every variant of the SpMV and SpMM kernels
(``DIA_VARIANT_CASES``, ``SPMM_VARIANT_K``: the shapes where they
switch between their 16-byte and scalar variants and between an
unrolled and a chunked diagonal loop, shared with the CPU tests
``test_torch_dia.py`` and ``test_torch_spmm.py``), and in both
variants of the SpGEMM kernel (``SPGEMM_KERNEL_CASES`` and the reach
cases: where it switches between its tiled and general variants and
where a tile meets the matrix's edge, shared with
``test_torch_spgemm.py``); the BSR SpMV and
SpMM kernels walk the stored nonzeros and sum in another order than
the plain versions' batched dense product, so rtol = atol = 1e-5,
with the NaN/inf pattern equal exactly where x holds inf or NaN
(``nonfinite_case``).  The ELL SpMV kernel sums each row's products in
slot order from +0.0, bit for bit its twin ``ell_spmv_ordered``
(``ELL_KERNEL_WIDTHS``, f32 and f64, int32 and int64 columns, shared
with the CPU tests ``test_torch_ell_kernel.py``; a wider pack takes the
plain ops and launches nothing); the
plain ELL ops (``ell_spmv_plain``) sum in another order, so 1e-5 (f32)
and 1e-12 (f64).  The CSR SpMV kernel (``test_csr_kernel_*``) is bit for
bit its twin ``csr_spmv_ordered`` on rows at every class edge of its
schedule (``CSR_KERNEL_HEAD``, shared with ``test_torch_csr_kernel.py``),
bit for bit the plain ops on a matrix with no row past 1,024 entries,
and within 1e-5 (f32) or 1e-12 (f64) of the largest |y| of a float64
scatter, a Graph500 graph's edge list included.  The BSR cases are shared with the CPU tests
(``test_torch_bsr.py``, ``test_torch_spmm.py``); the BSR kernels take
int16 column indices (compressed storage) as they take int32 and int64,
and the int16 SpMM agrees with the int32 one bit for bit.
Compressed storage (``csr_array.compress``) against a bf16 operand runs
the bf16 kernels; against an f32 operand it takes the plain widening
routes and launches no kernel.  Spans and latency timers make no device
synchronisation (``torch.profiler`` counts none).  The kernels at their
distributed call sites run in one spawned NCCL rank
(``parallel.launch.run_ranks``);
``test_dist_nccl_ranks_match_one_card`` runs one rank a card and skips
with fewer than two cards.  The graph and delta layers on the card
(``test_semiring_matvec_on_card``, ``test_delta_on_card``,
``test_mutation_stream_on_card``): the semiring products and the delta
serving are plain PyTorch, held to the same run on the CPU (min, max
and or bit for bit; sums at 1e-12), the delta base term through the DIA
kernel.  The serving path (``test_csr_rowids_repeat_exactly`` and the
engine, executor and gateway cases after it): csr-rowids gives the same
bits on every call, and the engine's plans, its stacked SpMM and its
multi-matrix stack are bit for bit the unpadded csr-rowids product; the
gateway serves banded and block matrices inline through their kernels.
The resilience layer (``test_resilient_cg_bitwise_on_card`` and the
cases after it): CG in its resilient stretches bit for bit the plain CG
with equal fetches and DIA launches, a retried stretch too; on one NCCL
rank the ABFT-checked ``dist_spmv`` through the DIA kernel (a clean
check; a poisoned y detected, retried, bit for bit) and a device loss
re-raised; ``test_recovery_ladder_nccl_ranks`` (two cards or more) the
survivor of a 2-rank ``dist_cg`` recovering alone.  The operations
layer (``test_placed_dot_matches_unplaced_on_card`` and after): a placed
tenant on a one-card slice serves through its DIA or BSR kernel bit for
bit the unplaced product, attribution on and off give the same bits,
and ``test_placement_submesh_nccl_ranks`` (two cards or more) a 2-rank
submesh's product bit for bit the one-card one, no collective outside
the slice.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu_torch as sparse
from legate_sparse_tpu_torch.ops import bsr as bsr_ops
from legate_sparse_tpu_torch.ops import csr_kernel
from legate_sparse_tpu_torch.ops import dia_kernel
from legate_sparse_tpu_torch.ops import ell_kernel
from legate_sparse_tpu_torch.ops import spmv as spmv_ops


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


def band_offsets(nd):
    """``nd`` distinct offsets on both sides of the main diagonal, odd
    and even (so x windows start on and off a 16-byte boundary)."""
    return tuple(2 * d - nd for d in range(nd))


# Where the DIA SpMV kernel switches variants: rows not divisible by 4
# (f32) or 8 (bf16) take the scalar variant; nd of 1 and of
# UNROLLED_DIAGS have their own unrolled instantiation; one more, and
# 33, take the chunked loop.  (rows, nd) per case.
_U = dia_kernel.UNROLLED_DIAGS
DIA_VARIANT_CASES = {"rows4099-nd5": (4099, 5), "nd1": (4096, 1),
                     f"nd{_U}": (4096, _U), f"nd{_U + 1}": (4096, _U + 1),
                     "nd33": (4096, 33)}
# Where the DIA SpMM kernel switches variants: k not divisible by 4
# (f32) or 8 (bf16) takes the scalar variant.  k -> nd, so every nd
# boundary meets a k boundary.
SPMM_VARIANT_K = {3: 1, 4: _U, 5: _U + 1, 17: 33}


def masked_pack(rows, cols, offsets, dtype, rng, device):
    """A row-aligned band pack with random holes and dead columns (every
    slot of the column a hole), and those columns: x or X may hold inf
    or NaN there without reaching y."""
    data = rng.standard_normal((len(offsets), cols)).astype(np.float32)
    mask = rng.random((len(offsets), cols)) > 0.2
    dead = np.arange(5, cols, 97)
    mask[:, dead] = False       # scipy layout: column j of A is slot j
    data[~mask] = 0.0
    packed = dia_kernel.pack_band(
        torch.from_numpy(data).to(device, dtype), offsets, (rows, cols),
        torch.from_numpy(mask).to(device))
    assert packed is not None and packed.rmask is not None
    return packed, dead


def poison(x, dead):
    """inf and NaN, alternately, in the rows ``dead`` of x (or X)."""
    x[torch.as_tensor(dead[::2], device=x.device)] = float("inf")
    x[torch.as_tensor(dead[1::2], device=x.device)] = float("nan")
    return x


def offset_view(shape, dtype, rng, device, offset):
    """A random tensor of ``shape`` that starts ``offset`` elements into
    a larger buffer (offset 1: off the 16-byte grid)."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(rng.standard_normal(n + offset).astype(
        np.float32)).to(device, dtype)
    return buf[offset:].view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("x_offset", [0, 1])
@pytest.mark.parametrize("case", sorted(DIA_VARIANT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_spmv_variants_match_plain(cuda, dtype, case, x_offset):
    rng = np.random.default_rng(4)
    rows, nd = DIA_VARIANT_CASES[case]
    packed, dead = masked_pack(rows, rows, band_offsets(nd), dtype, rng,
                               cuda)
    v = 16 // packed.rdata.element_size()
    assert dia_kernel.spmv_vector_ok(packed) == (rows % v == 0)
    x = poison(offset_view((rows,), dtype, rng, cuda, x_offset), dead)
    before = dia_kernel.dia_spmv.launches
    y = dia_kernel.dia_spmv(packed, x)
    assert dia_kernel.dia_spmv.launches == before + 1
    yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, x,
                                   packed.offsets, packed.shape)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and torch.equal(y, yp)


@pytest.mark.gpu
@pytest.mark.parametrize("x_offset", [0, 1])
@pytest.mark.parametrize("k", sorted(SPMM_VARIANT_K))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_spmm_variants_match_plain(cuda, dtype, k, x_offset):
    rng = np.random.default_rng(5)
    rows = 4099
    packed, dead = masked_pack(rows, rows, band_offsets(SPMM_VARIANT_K[k]),
                               dtype, rng, cuda)
    X = poison(offset_view((rows, k), dtype, rng, cuda, x_offset), dead)
    g = 16 // X.element_size()
    assert dia_kernel.spmm_vector_ok(packed, X) == (k % g == 0
                                                    and x_offset == 0)
    before = dia_kernel.dia_spmm.launches
    Y = dia_kernel.dia_spmm(packed, X)
    assert dia_kernel.dia_spmm.launches == before + 1
    Yp = dia_kernel.dia_spmm_plain(packed.rdata, packed.rmask, X,
                                   packed.offsets, packed.shape)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Y).all()) and torch.equal(Y, Yp)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["csr", "dia"])
def test_strided_x_on_card(cuda, kind):
    """``A @ X[:, 0]`` and ``A @ X[:, :1]`` (strided views) take the DIA
    kernel and equal the call on a contiguous copy bit for bit."""
    rng = np.random.default_rng(6)
    n = 5000
    if kind == "csr":
        S = _holey(n, rng)
        S.eliminate_zeros()
        A = sparse.csr_array(S, device=cuda)
    else:
        A = sparse.dia_array(
            (rng.standard_normal((3, n)).astype(np.float32),
             np.array([-2, 0, 5])), shape=(n, n), device=cuda)
    X = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    X = X.to(cuda)
    y_ref = A @ X[:, 0].contiguous()
    y = A @ X[:, 0]
    assert A.spmv_path == "dia-kernel"
    y1 = A @ X[:, :1]
    assert A.spmv_path == "dia-kernel" and tuple(y1.shape) == (n, 1)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref) and torch.equal(y1[:, 0], y_ref)


def _csr(rows, cols, shape, rng):
    A = sp.csr_array((rng.standard_normal(len(rows)).astype(np.float32),
                      (np.asarray(rows), np.asarray(cols))), shape=shape)
    A.sum_duplicates()
    return A


def nonfinite_case(seed=9):
    """A matrix and an x (or one column of X) with inf and NaN at
    columns that some rows of a present block store, at columns no row
    stores, and in the chunk of an empty block-row's zero block.

    Block-row 0 stores in chunk 1 only, and rows 0 and 1 store column
    130, where x is inf: those rows give a*inf, the others NaN (0*inf).
    Block-row 1 stores in chunk 2 only, and x is NaN at a column none of
    its rows stores: all NaN.  Block-row 2 is empty; its zero block
    multiplies chunk 0, which holds an inf: all NaN.  Block-row 3 stores
    in chunk 3, all finite.  Every row of block-row 4 stores column 520,
    where x is -inf, beside finite products: all -inf."""
    rng = np.random.default_rng(seed)
    rows, cols = [0, 1], [130, 130]
    for r in range(0, 128):
        rows += [r] * 3
        cols += list(128 + rng.choice(np.arange(1, 128), 3, replace=False))
    for r in range(128, 256):
        rows += [r] * 3
        cols += list(256 + rng.choice(np.arange(1, 128), 3, replace=False))
    for r in range(384, 512):
        rows += [r] * 4
        cols += list(384 + rng.choice(128, 4, replace=False))
    for r in range(512, 640):
        rows += [r, r]
        cols += [520, 521 + r % 100]
    A = _csr(rows, cols, (640, 640), rng)
    x = rng.standard_normal(640).astype(np.float32)
    x[130] = np.inf
    x[256] = np.nan          # column 256 is stored by no row
    x[5] = np.inf
    x[520] = -np.inf
    return A, x


def many_blocks_case(seed=10):
    """One block-row with 40 present blocks (more than a kernel stages
    at once), an empty block-row, and one row of 3,000 entries."""
    rng = np.random.default_rng(seed)
    ncols = 128 * 48
    bcols = rng.choice(48, 40, replace=False)
    rows, cols = [], []
    for r in range(0, 128):
        rows += [r] * 40
        cols += list(bcols * 128 + rng.integers(0, 128, 40))
    rows += [300] * 3000 + [301]
    cols += list(rng.choice(ncols, 3000, replace=False)) + [7]
    return _csr(rows, cols, (512, ncols), rng)


def assert_same_nonfinite(got, want):
    """Equal NaN/inf pattern (signs of inf included) and finite values
    within 1e-5 (numpy arrays)."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _bsr_structure(S, dtype, device, index_dtype=torch.int32):
    """The BSR structure of scipy CSR ``S`` on ``device``, whatever its
    block fill."""
    A = sparse.csr_array(S, dtype=dtype, device=device)
    return bsr_ops.build_structure(A.data, A.indices.to(index_dtype),
                                   A.indptr, A._get_row_ids(), A.shape, 1e9)


def _bsr_cases(rng):
    S = sp.random(4096, 3000, density=0.002, format="csr", random_state=rng,
                  dtype=np.float32)
    A, x = nonfinite_case()
    return {"random": (S, None), "nonfinite": (A, x),
            "many-blocks": (many_blocks_case(), None)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "nonfinite", "many-blocks"])
@pytest.mark.parametrize("index_dtype", [torch.int16, torch.int32,
                                         torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_matches_plain(cuda, dtype, index_dtype, case):
    rng = np.random.default_rng(5)
    S, x = _bsr_cases(rng)[case]
    st = _bsr_structure(S, dtype, cuda, index_dtype)
    xp = rng.standard_normal(st.nbc * 128).astype(np.float32)
    if x is not None:
        xp[: x.shape[0]] = x
    x2d = torch.from_numpy(xp.reshape(-1, 128)).to(cuda, dtype)
    before = bsr_ops.bsr_spmv.launches
    y = bsr_ops.bsr_spmv(st, x2d)
    assert bsr_ops.bsr_spmv.launches == before + 1
    yp = bsr_ops.bsr_spmv_plain(st, x2d)
    torch.cuda.synchronize()
    assert_same_nonfinite(y.cpu().numpy(), yp.cpu().numpy())


@pytest.mark.gpu
def test_csr_dot_dispatch_on_card(cuda):
    """On the card a banded f32 matrix takes the DIA kernel and an
    irregular one within the BSR budget takes the BSR kernel; an
    irregular f64 one within the ELL budget takes "ell", through the ELL
    kernel up to ``MAX_TILE_W`` slots a row and the plain ops above; an
    irregular f32 one over every budget takes "csr-rowids", through the
    CSR kernel."""
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
    # f64 is outside the BSR kernel's types: an irregular f64 matrix
    # within the ELL budget takes "ell", through the ELL kernel at 11
    # slots a row, through the plain ops at R's 37.
    N = sp.random(2048, 2048, density=0.002, format="csr", random_state=rng,
                  dtype=np.float64)
    x64 = xr.astype(np.float64)
    for M, launched in ((N, 1), (R.astype(np.float64), 0)):
        E = sparse.csr_array(M, device=cuda)
        before = ell_kernel.ell_spmv.launches
        y = E @ x64
        assert E.spmv_path == "ell"
        W = E._get_ell()[0].shape[1]
        assert (W <= ell_kernel.MAX_TILE_W) == bool(launched)
        assert ell_kernel.ell_spmv.launches == before + launched
        np.testing.assert_allclose(y.cpu().numpy(), M @ x64, rtol=1e-12,
                                   atol=1e-12)
    # An irregular f32 matrix over every budget (a 704-entry row breaks
    # ELL's and BSR's) takes csr-rowids, through the CSR kernel.
    G = engine_style(20_000)
    Gc = sparse.csr_array(G, device=cuda)
    xg = rng.standard_normal(20_000).astype(np.float32)
    before = csr_kernel.csr_spmv.launches
    y = Gc @ xg
    assert Gc.spmv_path == "csr-rowids"
    assert csr_kernel.csr_spmv.launches == before + 1
    np.testing.assert_allclose(y.cpu().numpy(), G @ xg, rtol=1e-5, atol=1e-5)


# ELL kernel widths: the V-cycle's R and P (9, 4), a single slot and the
# widest the kernel is compiled for; one slot wider takes the plain ops.
ELL_KERNEL_WIDTHS = (1, 4, 9, ell_kernel.MAX_TILE_W)
ELL_WIDE_W = ell_kernel.MAX_TILE_W + 1


def ell_case(rows, cols, W, rng, dtype, index_dtype, device):
    """An ELL pack of a random matrix whose rows hold 0 to W entries
    (every fifth row empty, rows 1 and 2 at least one), and its x.  The
    padded slots (value 0) name column 0, where x is NaN, which no
    stored slot names; row 1's first slot names column 1 (x = inf) and
    row 2's column 2 (x = -inf)."""
    counts = rng.integers(0, W + 1, rows)
    counts[::5] = 0
    counts[1:3] = np.maximum(counts[1:3], 1)
    stored = np.arange(W)[None, :] < counts[:, None]
    vals = np.where(stored, rng.standard_normal((rows, W)), 0.0)
    idx = np.where(stored, rng.integers(3, cols, (rows, W)), 0)
    idx[1, 0], idx[2, 0] = 1, 2
    x = rng.standard_normal(cols)
    x[:3] = np.nan, np.inf, -np.inf
    return (torch.from_numpy(vals).to(device, dtype),
            torch.from_numpy(idx).to(device, index_dtype),
            torch.from_numpy(counts.astype(np.int32)).to(device),
            torch.from_numpy(x).to(device, dtype))


def assert_bitwise(got, want):
    """Equal bits, NaN where NaN (``torch.equal`` fails every NaN)."""
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])


@pytest.mark.gpu
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("W", ELL_KERNEL_WIDTHS)
def test_ell_kernel_matches_slot_order(cuda, W, dtype, index_dtype):
    """The kernel against the plain products summed in slot order from
    +0.0 (``ell_spmv_ordered``): bit for bit, inf included; the NaN of x
    at the padded slots stays out of y, and empty rows read +0.0;
    against
    ``ell_spmv_plain``, whose ``sum`` takes another order, at 1e-5 (f32)
    and 1e-12 (f64) of each other, equal NaN/inf pattern.  3,001 rows:
    a ragged last block."""
    rng = np.random.default_rng(100 + W)
    data, cols, counts, x = ell_case(3001, 4000, W, rng, dtype, index_dtype,
                                     cuda)
    before = ell_kernel.ell_spmv.launches
    y = spmv_ops.ell_spmv(data, cols, counts, x)
    assert ell_kernel.ell_spmv.launches == before + 1
    assert y.dtype == dtype
    want = ell_kernel.ell_spmv_ordered(data, cols, counts, x)
    torch.cuda.synchronize()
    assert_bitwise(y, want)
    assert not y.isnan().any()
    assert y[1].isinf() and y[2].isinf()
    assert torch.equal(y[counts == 0], torch.zeros_like(y[counts == 0]))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    yp = spmv_ops.ell_spmv_plain(data, cols, counts, x)
    torch.testing.assert_close(y, yp, rtol=tol, atol=tol, equal_nan=True)


@pytest.mark.gpu
def test_ell_kernel_gmg_level0_r_and_p(cuda):
    """Level 0's restriction R (W 9) and prolongation P = R.T (W 4) of
    ``apps/gmg.linear_operator`` at a 256² grid.  In f32 (at this size
    ``csr_array.dot`` gives them to BSR; at 8192² they exceed its block
    budget) their ELL packs through ``spmv.ell_spmv``: the kernel, bit
    for bit their slot-order products, within 1e-6 of the plain ops.  In
    f64, outside BSR's types, ``dot`` itself takes "ell" and the kernel,
    within 1e-12 of the plain ops."""
    from legate_sparse_tpu_torch.apps.gmg import linear_operator
    rng = np.random.default_rng(7)
    x64 = torch.from_numpy(rng.standard_normal(256 * 256)).to(cuda)
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        R, _ = linear_operator(256 * 256, dtype=dtype, device=cuda)
        P = R.T
        x = x64.to(dtype)
        before = ell_kernel.ell_spmv.launches
        if dtype == torch.float64:
            r = R.dot(x)
            p = P.dot(r)
            assert R.spmv_path == P.spmv_path == "ell"
        else:
            r = spmv_ops.ell_spmv(*R._get_ell(), x)
            p = spmv_ops.ell_spmv(*P._get_ell(), r)
        assert ell_kernel.ell_spmv.launches == before + 2
        for M, v, out, W in ((R, x, r, 9), (P, r, p, 4)):
            ell = M._get_ell()
            assert ell[0].shape[1] == W
            assert_bitwise(out, ell_kernel.ell_spmv_ordered(*ell, v))
            torch.testing.assert_close(out, spmv_ops.ell_spmv_plain(*ell, v),
                                       rtol=tol, atol=tol)


@pytest.mark.gpu
def test_ell_kernel_rejects_bad_inputs(cuda):
    """Non-contiguous operands, mismatched shapes, types and devices
    raise before any launch; ``spmv.ell_spmv`` makes a strided x
    contiguous for the kernel."""
    rng = np.random.default_rng(3)
    data, cols, counts, x = ell_case(500, 600, 4, rng, torch.float32,
                                     torch.int32, cuda)
    before = ell_kernel.ell_spmv.launches
    bad = [
        (ValueError, (data.t().contiguous().t(), cols, counts, x)),
        (ValueError, (data, cols.t().contiguous().t(), counts, x)),
        (ValueError, (data, cols, counts, torch.stack([x, x], 1)[:, 0])),
        (ValueError, (data, cols[:-1], counts, x)),
        (ValueError, (data, cols, counts[:-1], x)),
        (ValueError, (data, cols, counts, x.cpu())),
        (TypeError, (data, cols, counts, x.double())),
        (TypeError, (data, cols, counts.long(), x)),
        (TypeError, (data, cols.short(), counts, x)),
        (ValueError, tuple(ell_case(500, 600, ELL_WIDE_W, rng,
                                    torch.float32, torch.int32, cuda))),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            ell_kernel.ell_spmv(*args)
    assert ell_kernel.ell_spmv.launches == before
    xs = torch.stack([x, x], 1)[:, 0]
    assert_bitwise(spmv_ops.ell_spmv(data, cols, counts, xs),
                   spmv_ops.ell_spmv(data, cols, counts, x))


@pytest.mark.gpu
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_wide_pack_on_card_stays_plain(cuda, dtype, index_dtype):
    """A pack wider than the kernel's ``MAX_TILE_W`` takes the plain ops
    on the card, bit for bit, and launches nothing."""
    rng = np.random.default_rng(5)
    data, cols, counts, x = ell_case(900, 1000, ELL_WIDE_W, rng, dtype,
                                     index_dtype, cuda)
    before = ell_kernel.ell_spmv.launches
    y = spmv_ops.ell_spmv(data, cols, counts, x)
    assert ell_kernel.ell_spmv.launches == before
    assert_bitwise(y, spmv_ops.ell_spmv_plain(data, cols, counts, x))


@pytest.mark.gpu
def test_ell_complex_on_card_stays_plain(cuda):
    """complex64 on the card is outside the kernel's types: the plain
    ops, no launch."""
    rng = np.random.default_rng(4)
    data, cols, counts, x = ell_case(700, 800, 9, rng, torch.float32,
                                     torch.int32, cuda)
    data = torch.complex(data, 0.5 * data)
    x = torch.complex(x.nan_to_num(), -x.nan_to_num())
    before = ell_kernel.ell_spmv.launches
    y = spmv_ops.ell_spmv(data, cols, counts, x)
    assert ell_kernel.ell_spmv.launches == before
    assert y.dtype == torch.complex64
    assert torch.equal(y, spmv_ops.ell_spmv_plain(data, cols, counts, x))


# ---- the CSR SpMV kernel (csrc/csr_spmv.cu) ------------------------------
#
# Rows at every class edge of the kernel's schedule: empty rows leading
# and trailing, CHUNK - 1, CHUNK (the longest summed in slot order) and
# CHUNK + 1 (the shortest hub row, two chunks), 2 CHUNK and 2 CHUNK + 1,
# a hub row of many chunks, a regular and a hub row whose products are
# all -0.0 (column 3, x = -0.0), a row that stores column 1 (x = NaN)
# and a hub row that stores column 2 (x = inf); column 0 (x = NaN) is
# stored nowhere.  ``tail`` adds 2,000 short rows, a run of 2,500 empty
# rows (more than a tile's TILE_ROWS) and 300 rows of 0 to 1,500.
_C = csr_kernel.CHUNK
CSR_KERNEL_HEAD = (0, 0, 3, _C - 1, _C, _C + 1, 0, 1, 2 * _C, 2 * _C + 1,
                   40 * _C + 3, 5, _C + 5, 7, 3 * _C)
CSR_NEG_ZERO_ROWS = (11, 12)
CSR_NAN_ROW, CSR_INF_ROW = 13, 14


def csr_kernel_case(rng, dtype, index_dtype, offset_dtype, device,
                    tail=True, cols=50_000):
    """``(data, indices, offsets, x)`` of the rows above."""
    lengths = list(CSR_KERNEL_HEAD)
    if tail:
        lengths += (list(rng.integers(0, 41, 2000)) + [0] * 2500
                    + list(rng.integers(0, 1501, 300)))
    lengths += [0, 0]
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    nnz = int(offsets[-1])
    idx = rng.integers(4, cols, nnz)
    data = rng.standard_normal(nnz)
    for r in CSR_NEG_ZERO_ROWS:
        a, b = offsets[r], offsets[r + 1]
        idx[a:b] = 3
        data[a:b] = np.abs(data[a:b]) + 0.5
    idx[offsets[CSR_NAN_ROW] + 2] = 1
    idx[offsets[CSR_INF_ROW] + 1500] = 2
    x = rng.standard_normal(cols)
    x[:4] = np.nan, np.nan, np.inf, -0.0
    return (torch.from_numpy(data).to(device, dtype),
            torch.from_numpy(idx).to(device, index_dtype),
            torch.from_numpy(offsets).to(device, offset_dtype),
            torch.from_numpy(x).to(device, dtype))


def csr_f64_reference(data, indices, offsets, x):
    """``A @ x`` scattered in float64 on the CPU."""
    offsets = offsets.cpu().to(torch.int64)
    lengths = offsets[1:] - offsets[:-1]
    rows = torch.repeat_interleave(torch.arange(lengths.shape[0]), lengths)
    return torch.zeros(lengths.shape[0], dtype=torch.float64).index_add_(
        0, rows, data.cpu().double() * x.cpu().double()[indices.cpu().long()])


def assert_csr_case_rows(y, offsets):
    """The special rows of ``csr_kernel_case``: empty and -0.0 rows read
    +0.0, the NaN of x reaches its row alone, the inf its row."""
    lengths = (offsets[1:] - offsets[:-1]).to(y.device)
    quiet = torch.cat([y[lengths == 0], y[list(CSR_NEG_ZERO_ROWS)]])
    assert torch.equal(quiet, torch.zeros_like(quiet))
    assert not torch.signbit(quiet).any()
    assert y.isnan().nonzero().flatten().tolist() == [CSR_NAN_ROW]
    assert y[CSR_INF_ROW].isinf()


@pytest.mark.gpu
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_kernel_matches_ordered(cuda, dtype, index_dtype):
    """The kernel against its plain twin ``csr_spmv_ordered`` bit for bit,
    through ``spmv.csr_spmv_rowids`` (int64 offsets from the lengths)
    and directly (int32 and int64 offsets), one launch each; within 1e-5
    (f32) or 1e-12 (f64) of the largest |y| of a float64 scatter."""
    rng = np.random.default_rng(40)
    data, cols, offsets, x = csr_kernel_case(rng, dtype, index_dtype,
                                             torch.int64, cuda)
    want = csr_kernel.csr_spmv_ordered(data, cols, offsets, x)
    lengths = offsets[1:] - offsets[:-1]
    before = csr_kernel.csr_spmv.launches
    y = spmv_ops.csr_spmv_rowids(data, cols, None, x, lengths.shape[0],
                                 lengths=lengths)
    assert csr_kernel.csr_spmv.launches == before + 1
    assert y.dtype == dtype
    torch.cuda.synchronize()
    assert_bitwise(y, want)
    assert_csr_case_rows(y, offsets)
    for odt in (torch.int32, torch.int64):
        assert_bitwise(csr_kernel.csr_spmv(data, cols, offsets.to(odt), x),
                       want)
    assert csr_kernel.csr_spmv.launches == before + 3
    ref = csr_f64_reference(data, cols, offsets, x)
    fin = ref.isfinite()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    err = (y.cpu().double()[fin] - ref[fin]).abs().max()
    assert err <= tol * ref[fin].abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_kernel_serial_matrix_equals_plain(cuda, dtype):
    """On an engine-style matrix (longest row 704, within
    ``SERIAL_MAX_ROW``) every row sums in slot order: ``A @ x`` through
    the kernel is bit for bit the plain ops' one-thread-a-row sums."""
    A = sparse.csr_array(engine_style((1 << 16) - 91).astype(
        np.float64 if dtype == torch.float64 else np.float32), device=cuda)
    assert A._serial_rows()
    x = _card_x(A.shape[1], cuda, dtype)
    before = csr_kernel.csr_spmv.launches
    y = A @ x
    assert A.spmv_path == "csr-rowids"
    assert csr_kernel.csr_spmv.launches == before + 1
    plain = spmv_ops.csr_spmv_rowids_plain(
        A.data, A.indices, A._get_row_ids(), x, A.shape[0],
        lengths=A._get_row_lengths(), serial=True)
    assert torch.equal(y, plain)


@pytest.mark.gpu
def test_csr_kernel_graph500(cuda):
    """A Graph500 Kronecker graph at SCALE 18 (the benchmark's family,
    ``utils_test/graph500_ref.py``): ``A @ x`` takes csr-rowids and the
    kernel, bit for bit ``csr_spmv_ordered``, within 1e-5 of the largest
    |y| of the edge list scattered in float64 (f32 sums of up to ~10^4
    terms; one entry of typical size left out reads ~1e-3)."""
    from utils_test import graph500_ref

    data, cols, indptr = graph500_ref.assemble(18, 26)
    n = indptr.shape[0] - 1
    A = sparse.csr_array((data.float().numpy(), cols.numpy(),
                          indptr.numpy()), shape=(n, n), device=cuda)
    x = torch.rand(n, generator=torch.Generator().manual_seed(5))
    before = csr_kernel.csr_spmv.launches
    y = A @ x.to(cuda)
    assert A.spmv_path == "csr-rowids" and not A._serial_rows()
    assert csr_kernel.csr_spmv.launches == before + 1
    # The probes that declined left no row ids behind.
    assert A._row_ids is None
    assert_bitwise(y, csr_kernel.csr_spmv_ordered(A.data, A.indices,
                                                  A.indptr, x.to(cuda)))
    ref = graph500_ref.apply(18, 26, x)
    err = (y.cpu().double() - ref).abs().max() / ref.abs().max()
    assert err <= 1e-5


@pytest.mark.gpu
def test_csr_kernel_rejects_bad_inputs(cuda):
    """Non-contiguous operands, mismatched shapes, types and devices
    raise before any launch; ``spmv.csr_spmv_rowids`` makes a strided x
    contiguous for the kernel."""
    rng = np.random.default_rng(41)
    data, cols, offsets, x = csr_kernel_case(rng, torch.float32,
                                             torch.int32, torch.int64, cuda,
                                             tail=False)
    before = csr_kernel.csr_spmv.launches
    bad = [
        (ValueError, (torch.stack([data, data], 1)[:, 0], cols, offsets, x)),
        (ValueError, (data, torch.stack([cols, cols], 1)[:, 0], offsets, x)),
        (ValueError, (data, cols, offsets, torch.stack([x, x], 1)[:, 0])),
        (ValueError, (data, cols[:-1], offsets, x)),
        (ValueError, (data, cols, offsets, x.cpu())),
        (TypeError, (data, cols, offsets, x.double())),
        (TypeError, (data, cols.short(), offsets, x)),
        (TypeError, (data, cols, offsets.float(), x)),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            csr_kernel.csr_spmv(*args)
    assert csr_kernel.csr_spmv.launches == before
    rows = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    xs = torch.stack([x, x], 1)[:, 0]
    assert_bitwise(spmv_ops.csr_spmv_rowids(data, cols, None, xs, rows,
                                            lengths=lengths),
                   spmv_ops.csr_spmv_rowids(data, cols, None, x, rows,
                                            lengths=lengths))


@pytest.mark.gpu
def test_csr_complex_on_card_stays_plain(cuda):
    """complex64 on the card is outside the kernel's types: the plain
    ops, no launch."""
    rng = np.random.default_rng(42)
    data, cols, offsets, x = csr_kernel_case(rng, torch.float32,
                                             torch.int32, torch.int64, cuda,
                                             tail=False)
    x = x.nan_to_num(nan=0.0, posinf=1.0)
    data, x = torch.complex(data, 0.5 * data), torch.complex(x, -x)
    rows = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    before = csr_kernel.csr_spmv.launches
    y = spmv_ops.csr_spmv_rowids(data, cols, None, x, rows, lengths=lengths)
    assert csr_kernel.csr_spmv.launches == before
    assert y.dtype == torch.complex64
    assert torch.equal(y, spmv_ops.csr_spmv_rowids_plain(
        data, cols, None, x, rows, lengths=lengths))


@pytest.mark.gpu
def test_csr_kernel_span_nests_with_counts(cuda):
    """While tracing is on, the kernel's ``kernel.csr_spmv`` span nests
    in ``kernel.csr_rowids`` and carries the schedule's hub rows and
    chunks."""
    from legate_sparse_tpu_torch import obs

    rng = np.random.default_rng(43)
    data, cols, offsets, x = csr_kernel_case(rng, torch.float32,
                                             torch.int32, torch.int64, cuda,
                                             tail=False)
    A = sparse.csr_array((data, cols, offsets),
                         shape=(offsets.shape[0] - 1, x.shape[0]))
    obs.reset_all()
    obs.trace.enable()
    try:
        A @ x
    finally:
        obs.trace.disable()
    recs = obs.records()
    (outer,) = [r for r in recs if r["name"] == "kernel.csr_rowids"]
    (inner,) = [r for r in recs if r["name"] == "kernel.csr_spmv"]
    lengths = (offsets[1:] - offsets[:-1]).cpu()
    hub = lengths > csr_kernel.CHUNK
    assert inner["attrs"] == {
        "hub_rows": int(hub.sum()),
        "chunks": int(((lengths[hub] + csr_kernel.CHUNK - 1)
                       // csr_kernel.CHUNK).sum())}
    assert inner["depth"] > outer["depth"]
    obs.reset_all()


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
@pytest.mark.parametrize("case", ["random", "nonfinite", "many-blocks"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 5, 16, 40])
def test_bsr_spmm_kernel_matches_plain(cuda, dtype, k, case):
    rng = np.random.default_rng(6)
    S, x = _bsr_cases(rng)[case]
    st = _bsr_structure(S, dtype, cuda)
    X = rng.standard_normal((st.nbc * 128, k)).astype(np.float32)
    if x is not None:
        X[: x.shape[0], k // 2] = x
    X = torch.from_numpy(X).to(cuda, dtype)
    before = bsr_ops.bsr_spmm.launches
    Y = bsr_ops.bsr_spmm(st, X)
    assert bsr_ops.bsr_spmm.launches == before + 1
    Yp = bsr_ops.bsr_spmm_plain(st, X)
    torch.cuda.synchronize()
    assert_same_nonfinite(Y.cpu().numpy(), Yp.cpu().numpy())


_PM2 = (-2, -1, 0, 1, 2)
# Where the banded SpGEMM kernel (``csrc/dia_spgemm.cu``) switches
# between its tiled and general variants, and the edges of its tiles of
# ``dia_kernel.SPGEMM_TILE`` columns: (m, k, n, offs_a, offs_b) per
# case, shared with the CPU tests (``test_torch_spgemm.py``).  In
# "rect-empty-diag" the output diagonal -2698 has no valid pair, so its
# row of C is 0.  The "reach-*" cases (``spgemm_reach_case``) put A's
# staged reach exactly at the tiled variant's shared-memory limit and
# one column past it.
SPGEMM_KERNEL_CASES = {
    "pm2": (5000, 4000, 4500, _PM2, _PM2),
    "far": (5000, 4000, 4500, (-300, 0, 7), (-5, 0, 299)),
    "n-below-tile": (700, 700, 700, _PM2, _PM2),
    "n-not-tile-multiple": (5000, 5001, 4999, (-3, 0, 2), (-1, 0, 4)),
    "rect-empty-diag": (1500, 1200, 1300, (-1499, 0, 3), (-1199, 0, 2)),
    "nd9": (20000, 20000, 20000, band_offsets(9), band_offsets(9)),
    "nd33": (20000, 20000, 20000, band_offsets(33), band_offsets(33)),
}


def spgemm_offs_c(offs_a, offs_b):
    return tuple(sorted({a + b for a in offs_a for b in offs_b}))


def spgemm_reach_case(dtype, past: bool):
    """(m, k, n, offs_a, offs_b) with A's staged reach (the span of
    offs_b) the widest the tiled variant takes in ``dtype``, or one
    column wider: 2 + 2 diagonals into 4, with 4 pairs."""
    span = dia_kernel.spgemm_max_span(2, 2, 4, 4, dtype) + past
    return span + 600, span + 600, span + 600, (-1, 0), (0, span)


def spgemm_case(name, dtype):
    if name.startswith("reach-"):
        return spgemm_reach_case(dtype, name == "reach-past-limit")
    return SPGEMM_KERNEL_CASES[name]


# The variant each case takes: the tiled one, except past the reach
# limit and, in f32, at 33 diagonals (the staged bands pass 227 KB).
def spgemm_expect_tiled(name, dtype):
    return not (name == "reach-past-limit"
                or (name == "nd33" and dtype == torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SPGEMM_KERNEL_CASES) + [
    "reach-at-limit", "reach-past-limit", "aliased", "twice"])
def test_dia_spgemm_kernel_matches_plain(cuda, dtype, case):
    """Bit for bit with the plain version in each variant.  "aliased"
    passes one tensor as A and B; "twice" calls the kernel twice with
    no synchronisation between (the pair table is cached on the card,
    so the second call copies nothing), equal both times."""
    rng = np.random.default_rng(3)
    m, k, n, offs_a, offs_b = (spgemm_case("pm2", dtype)
                               if case in ("aliased", "twice")
                               else spgemm_case(case, dtype))
    if case == "aliased":
        m = k = n = 9000
    offs_c = spgemm_offs_c(offs_a, offs_b)
    a = torch.from_numpy(rng.standard_normal((len(offs_a), k))
                         .astype(np.float32)).to(cuda, dtype)
    b = a if case == "aliased" else torch.from_numpy(
        rng.standard_normal((len(offs_b), n)).astype(np.float32)).to(
            cuda, dtype)
    pairs = dia_kernel.spgemm_pairs(offs_a, offs_b, offs_c, (m, k), (k, n))
    assert dia_kernel.spgemm_tiled_ok(
        offs_a, offs_b, offs_c, sum(map(len, pairs)), (m, k), (k, n),
        dtype) == spgemm_expect_tiled(case, dtype)
    before = dia_kernel.dia_spgemm.launches
    C = dia_kernel.dia_spgemm(a, b, offs_a, offs_b, offs_c, (m, k), (k, n))
    assert dia_kernel.dia_spgemm.launches == before + 1
    if case == "twice":
        C2 = dia_kernel.dia_spgemm(a, b, offs_a, offs_b, offs_c, (m, k),
                                   (k, n))
        assert dia_kernel.dia_spgemm.launches == before + 2
    Cp = dia_kernel.dia_spgemm_plain(a, b, offs_a, offs_b, offs_c, (m, k),
                                     (k, n))
    torch.cuda.synchronize()
    assert C.dtype == dtype and torch.equal(C, Cp)
    if case == "twice":
        assert torch.equal(C2, Cp)
    if case == "rect-empty-diag":
        empty = [ci for ci, ps in enumerate(pairs) if not ps]
        assert empty and not bool(C[empty].any())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "nonfinite", "many-blocks"])
def test_bsr_plain_versions_repeat_exactly(cuda, case):
    """The plain BSR versions sum each block-row's block products by a
    segment sum over ``bptr``'s runs, in one fixed order: two calls on
    one input give the same bits, NaN and inf included (an
    ``index_add_`` would add atomically in no fixed order)."""
    rng = np.random.default_rng(7)
    S, x = _bsr_cases(rng)[case]
    st = _bsr_structure(S, torch.float32, cuda)
    xp = rng.standard_normal(st.nbc * 128).astype(np.float32)
    if x is not None:
        xp[: x.shape[0]] = x
    x2d = torch.from_numpy(xp.reshape(-1, 128)).to(cuda)

    def same_bits(a, b):    # NaN included, which torch.equal is not
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    assert same_bits(bsr_ops.bsr_spmv_plain(st, x2d),
                     bsr_ops.bsr_spmv_plain(st, x2d))
    X = torch.from_numpy(rng.standard_normal(
        (st.nbc * 128, 40)).astype(np.float32)).to(cuda)
    assert same_bits(bsr_ops.bsr_spmm_plain(st, X),
                     bsr_ops.bsr_spmm_plain(st, X))


@pytest.mark.gpu
def test_setdiag_then_dot_on_card(cuda):
    """The caches of a mutated matrix on the card: after a value-only
    ``setdiag`` and one that inserts a diagonal, ``A @ x`` launches the
    DIA kernel over the new band and agrees with scipy's f64 product
    (f32 rounding: 2e-6 of each row's sum of magnitudes)."""
    n = 200_000
    rng = np.random.default_rng(11)
    S = sp.diags([rng.standard_normal(n - 1), rng.standard_normal(n),
                  rng.standard_normal(n - 1)], [-1, 0, 1], format="csr",
                 dtype=np.float32)
    A = sparse.csr_array(S, device=cuda)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    A @ x
    S = S.astype(np.float64).tolil()
    for val, k in ((5.0, 0), (1.0, 2)):
        A.setdiag(val, k=k)
        S.setdiag(val, k=k)
        before = dia_kernel.dia_spmv.launches
        y = A @ x
        assert A.spmv_path == "dia-kernel"
        assert dia_kernel.dia_spmv.launches == before + 1
        Sc = S.tocsr()
        xn = x.double().cpu().numpy()
        err = np.abs(y.double().cpu().numpy() - Sc @ xn)
        assert np.all(err <= 2e-6 * (abs(Sc) @ np.abs(xn)) + 1e-30)
    assert A._dia_offsets == (-1, 0, 1, 2)


@pytest.mark.gpu
def test_sum_axis0_repeats_exactly(cuda):
    """Column sums are segment sums over column-sorted values: two calls
    give equal tensors on the card (a scatter-add would not)."""
    S = sp.random(50_000, 300, density=0.05, format="csr", random_state=3,
                  dtype=np.float32)
    A = sparse.csr_array(S, device=cuda)
    s1, s2 = A.sum(axis=0), A.sum(axis=0)
    assert torch.equal(s1, s2)
    np.testing.assert_allclose(
        s1.cpu().numpy(), np.asarray(S.astype(np.float64).sum(axis=0)).ravel(),
        rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("add", ["min", "max"])
def test_semiring_spmm_on_card_matches_cpu(cuda, add):
    """The min-plus and max-plus SpMM csgraph relaxes with: on the card
    bit for bit with the CPU (min and max do not depend on order), a
    padded suffix and inf in X included."""
    from legate_sparse_tpu_torch.ops import spmv as spmv_ops

    rng = np.random.default_rng(12)
    S = sp.random(20_000, 15_000, density=5e-4, format="csr",
                  random_state=rng)
    data = torch.from_numpy(rng.standard_normal(S.nnz))
    indices = torch.from_numpy(S.indices.astype(np.int64))
    row_ids = torch.from_numpy(np.repeat(np.arange(20_000),
                                         np.diff(S.indptr)))
    X = torch.from_numpy(rng.standard_normal((15_000, 8)))
    X[torch.from_numpy(rng.integers(0, 15_000, 50)), 0] = torch.inf
    valid = S.nnz - 11
    want = spmv_ops.csr_semiring_spmm_rowids_masked(
        data, indices, row_ids, valid, X, 20_000, add, "plus")
    got = spmv_ops.csr_semiring_spmm_rowids_masked(
        data.to(cuda), indices.to(cuda), row_ids.to(cuda), valid,
        X.to(cuda), 20_000, add, "plus")
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_eigsh_on_card_matches_cpu(cuda):
    """``eigsh`` on the card (its SpMVs through the DIA kernel) against
    the same call on the CPU (the plain version): f32 eigenvalues to
    1e-5 relative, residuals to 1e-3 of the largest."""
    from legate_sparse_tpu_torch import linalg

    n = 50_000
    rng = np.random.default_rng(13)
    diag = rng.uniform(1.0, 2.0, n)
    diag[[7, 1000, 20_000, 49_000]] = [5.0, 6.0, 7.0, 8.0]
    S = sp.diags([diag, np.full(n - 1, -0.1), np.full(n - 1, -0.1)],
                 [0, 1, -1], format="csr", dtype=np.float32)
    A = sparse.csr_array(S, device=cuda)
    before = dia_kernel.dia_spmv.launches
    w, V = linalg.eigsh(A, k=4, which="LA")
    assert A.spmv_path == "dia-kernel"
    assert dia_kernel.dia_spmv.launches > before
    assert w.device.type == "cuda" and V.device.type == "cuda"
    wc, _ = linalg.eigsh(sparse.csr_array(S, device="cpu"), k=4,
                         which="LA")
    np.testing.assert_allclose(w.cpu().numpy(), wc.numpy(), rtol=1e-5)
    Vn = V.double().cpu().numpy()
    resid = np.linalg.norm(S.astype(np.float64) @ Vn
                           - Vn * w.double().cpu().numpy()[None, :], axis=0)
    assert np.all(resid <= 1e-3 * 8.0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "nonfinite", "many-blocks"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 16, 40])
def test_bsr_spmm_int16_indices_match_int32(cuda, dtype, k, case):
    """The int16 instantiation reads the same entries in the same order
    as the int32 one (held against the plain version above), so the two
    agree bit for bit, NaN and inf included."""
    rng = np.random.default_rng(7)
    S, x = _bsr_cases(rng)[case]
    st16 = _bsr_structure(S, dtype, cuda, torch.int16)
    st32 = _bsr_structure(S, dtype, cuda, torch.int32)
    assert st16.indices.dtype == torch.int16
    X = rng.standard_normal((st16.nbc * 128, k)).astype(np.float32)
    if x is not None:
        X[: x.shape[0], k // 2] = x
    X = torch.from_numpy(X).to(cuda, dtype)
    before = bsr_ops.bsr_spmm.launches
    Y16 = bsr_ops.bsr_spmm(st16, X)
    assert bsr_ops.bsr_spmm.launches == before + 1
    Y32 = bsr_ops.bsr_spmm(st32, X)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(Y16.cpu().numpy(), Y32.cpu().numpy())


def _launches():
    """Launch counts of the DIA SpMV and SpMM, BSR SpMV and SpMM, ELL
    SpMV and CSR SpMV kernels."""
    return (dia_kernel.dia_spmv.launches, dia_kernel.dia_spmm.launches,
            bsr_ops.bsr_spmv.launches, bsr_ops.bsr_spmm.launches,
            ell_kernel.ell_spmv.launches, csr_kernel.csr_spmv.launches)


@pytest.mark.gpu
def test_compressed_bf16_operands_run_the_bf16_kernels(cuda):
    """Compressed storage against a bf16 operand: the DIA kernels bit
    for bit with their plain versions, the BSR kernels (int16 indices)
    at 1e-5 of theirs."""
    rng = np.random.default_rng(20)
    n = 40_000
    C = _cuda_band(n, [-200, -1, 0, 1, 200], rng, torch.float32,
                   cuda).compress()
    assert C.dtype == torch.bfloat16 and C._get_dia()[2] is None
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        cuda, torch.bfloat16)
    X = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    before = _launches()
    y, Y = C @ x, C @ X
    assert C.spmv_path == C.spmm_path == "dia-kernel"
    assert _launches() == (before[0] + 1, before[1] + 1) + before[2:]
    pk = C._get_dia_pack()
    assert torch.equal(y, dia_kernel.dia_spmv_plain(
        pk.rdata, pk.rmask, x, pk.offsets, pk.shape))
    assert torch.equal(Y, dia_kernel.dia_spmm_plain(
        pk.rdata, pk.rmask, X, pk.offsets, pk.shape))
    R = sp.random(2048, 2048, density=0.01, format="csr", random_state=rng,
                  dtype=np.float32)
    Rc = sparse.csr_array(R, device=cuda).compress()
    assert Rc.indices.dtype == torch.int16
    xr = torch.from_numpy(rng.standard_normal(2048).astype(np.float32)).to(
        cuda, torch.bfloat16)
    Xr = torch.from_numpy(rng.standard_normal((2048, 16)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    before = _launches()
    yr, Yr = Rc @ xr, Rc @ Xr
    assert Rc.spmv_path == Rc.spmm_path == "bsr"
    assert _launches() == before[:2] + (before[2] + 1, before[3] + 1) \
        + before[4:]
    st = Rc._get_bsr()
    yp = bsr_ops.bsr_spmv_plain(st, xr.reshape(-1, 128))
    Yp = bsr_ops.bsr_spmm_plain(st, Xr)
    torch.cuda.synchronize()
    np.testing.assert_allclose(yr.float().cpu().numpy(),
                               yp.reshape(-1)[:2048].cpu().numpy(),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(Yr.float().cpu().numpy(),
                               Yp[:2048].cpu().numpy(), rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
def test_lowp_routes_launch_no_kernel(cuda):
    """Compressed storage against an f32 operand: the plain widening
    routes, no kernel launch, f32 out.  The Poisson values (4, -1) are
    exact in bf16, so the band's result equals the f32 matrix's up to
    summation order; the irregular matrix's against its rounded values
    in f32."""
    n = 64 * 64
    A = sparse.diags([np.full(n, 4.0), -np.ones(n - 1), -np.ones(n - 1),
                      -np.ones(n - 64), -np.ones(n - 64)],
                     [0, 1, -1, 64, -64], shape=(n, n), format="csr",
                     dtype=torch.float32, device=cuda)
    C = A.compress()
    x = torch.linspace(-1.0, 1.0, n, device=cuda)
    X = torch.stack([x, 2 * x], dim=1)
    before = _launches()
    y, Y = C @ x, C @ X
    assert _launches() == before
    assert C.spmv_path == C.spmm_path == "dia-torch"
    assert y.dtype == Y.dtype == torch.float32
    torch.testing.assert_close(y, A @ x, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(Y, A @ X, rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(21)
    R = sp.random(2048, 2048, density=0.01, format="csr", random_state=rng,
                  dtype=np.float32)
    Rc = sparse.csr_array(R, device=cuda).compress()
    W = Rc.astype_storage(values="float32", indices="int32")
    assert W._get_bsr() is not None     # the f32 copy takes BSR
    xr = torch.from_numpy(rng.standard_normal(2048).astype(np.float32)).to(
        cuda)
    before = _launches()
    yr = Rc @ xr
    Yr = Rc @ torch.stack([xr, -xr], dim=1)
    assert _launches() == before
    assert Rc.spmv_path in ("ell-bf16", "csr-rowids-bf16")
    assert Rc.spmm_path == "csr-rowids-bf16"
    ref = sp.csr_matrix((W.data.double().cpu().numpy(),
                         W.indices.cpu().numpy(), W.indptr.cpu().numpy()),
                        shape=W.shape) @ xr.double().cpu().numpy()
    np.testing.assert_allclose(yr.cpu().numpy(), ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Yr[:, 1].cpu().numpy(), -ref, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.gpu
def test_spans_and_timers_add_no_device_sync(cuda):
    """Ten ``A @ x`` with tracing on (a span, a latency timer, the
    kernel span) make no synchronising call: the profiler's trace holds
    the same synchronisations as with tracing off, which are the
    profiler's own (one ``cudaDeviceSynchronize`` as it stops), fewer
    than the calls."""
    from torch.profiler import ProfilerActivity, profile

    from legate_sparse_tpu_torch import obs

    A = _cuda_band(200_000, [-1, 0, 1], np.random.default_rng(22),
                   torch.float32, cuda)
    x = torch.ones(200_000, device=cuda)

    def syncs(traced: bool) -> dict:
        obs.trace.enable() if traced else obs.trace.disable()
        try:
            A @ x
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    A @ x
            torch.cuda.synchronize()
        finally:
            obs.trace.disable()
        return {e.key: e.count for e in prof.key_averages()
                if "synchronize" in e.key.lower()}

    untraced, traced = syncs(False), syncs(True)
    assert traced == untraced
    assert sum(traced.values()) <= 1
    spans = [r for r in obs.records() if r["name"] == "spmv"]
    assert len(spans) >= 10 and spans[-1]["attrs"]["path"] == "dia-kernel"
    obs.reset_all()


# ---- the kernels at their distributed call sites (NCCL, world size 1) ----
#
# ``parallel.dist_spmv``/``dist_spmm`` run the DIA kernels on the
# halo-extended window (offsets shifted by +halo, a merged int8 mask)
# and the BSR kernel on a row block against the all-gathered x.  One
# spawned NCCL rank (``parallel.launch.run_ranks``) runs every case and
# returns, per case, whether the kernel launched and equals its plain
# version on the window (bit for bit: DIA; 1e-5 with equal NaN/inf:
# BSR) and whether ``dist_spmv`` equals the single-device ``A @ x``
# (NaN where it has NaN: bf16 storage keeps no hole mask).
# rows (= rps at one rank) 4099 and 4101 take the scalar variant, 4096
# the 16-byte one; "reach" puts the halo at its limit (the band reaches
# rps - 1, the window 3 rps - 2).

DIST_DIA_CASES = {
    # name -> (rows, offsets, holes with inf/NaN in x)
    "rps4099": (4099, (-3, -1, 0, 1, 3), False),
    "rps4096": (4096, (-3, -1, 0, 1, 3), False),
    "rps4101-holes": (4101, (-64, -1, 0, 1, 64), True),
    "reach": (2048, (-2047, -1, 0, 1, 2047), False),
}


def _dist_dia_matrix(rows, offsets, holes, dtype, device, rng):
    diagonals = []
    for o in offsets:
        d = rng.standard_normal(rows - abs(o)).astype(np.float32)
        if holes:
            d[::5] = 0.0
        diagonals.append(d)
    S = sp.diags(diagonals, list(offsets), shape=(rows, rows), format="csr")
    S.eliminate_zeros()
    return S, sparse.csr_array(S, dtype=dtype, device=device)


def _same(a, b):
    """Equal values, NaN where the other has NaN (``torch.equal`` calls
    two NaNs unequal)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(
        torch.where(na, 0, a), torch.where(nb, 0, b)))


def _dist_cases(rank, world):
    """Every distributed kernel case on this NCCL rank."""
    from legate_sparse_tpu_torch import parallel as P
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    dev = torch.device("cuda")
    mesh = P.make_row_mesh()
    group = mesh.get_group("rows")
    rng = np.random.default_rng(31)
    out = {}
    for name, (rows, offsets, holes) in DIST_DIA_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            S, A = _dist_dia_matrix(rows, offsets, holes, dtype, dev, rng)
            dA = P.shard_csr(A, mesh)
            pk = dA.dia_pack
            x = torch.from_numpy(rng.standard_normal(rows).astype(
                np.float32)).to(dev, dtype)
            if holes:
                # inf/NaN where only holes (and the ring-wrapped halo) read.
                dead = np.setdiff1d(np.arange(rows), S.indices)
                poison(x, dead)
            xw = D._extend_x(x, dA.halo, group)
            before = dia_kernel.dia_spmv.launches
            y = dia_kernel.dia_spmv(pk, xw)
            launched = dia_kernel.dia_spmv.launches - before
            yp = dia_kernel.dia_spmv_plain(pk.rdata, pk.rmask, xw,
                                           pk.offsets, pk.shape)
            yd = P.dist_spmv(dA, D.shard_vector(x, mesh, dA.rows_padded))
            X = torch.from_numpy(rng.standard_normal((rows, 16)).astype(
                np.float32)).to(dev, dtype)
            Xw = D._extend_x(X, dA.halo, group)
            before = dia_kernel.dia_spmm.launches
            Y = dia_kernel.dia_spmm(pk, Xw)
            launched_mm = dia_kernel.dia_spmm.launches - before
            Yp = dia_kernel.dia_spmm_plain(pk.rdata, pk.rmask, Xw,
                                           pk.offsets, pk.shape)
            Yd = P.dist_spmm(dA, D.shard_dense(X, mesh, dA.rows_padded))
            torch.cuda.synchronize()
            out[f"{name}-{str(dtype)[6:]}"] = {
                "halo": dA.halo, "window": tuple(pk.shape),
                "offsets": pk.offsets, "masked": pk.rmask is not None,
                "variant": dia_kernel.spmv_vector_ok(pk),
                "spmv_launched": launched, "spmm_launched": launched_mm,
                "spmv_bitwise": _same(y, yp), "spmm_bitwise": _same(Y, Yp),
                "dist_vs_single": _same(yd.full_tensor(), A @ x),
                "dist_spmm_vs_single": _same(Yd.full_tensor(), A @ X),
                "finite": bool(torch.isfinite(y).all())}
    # BSR on a row block against the all-gathered x: a block-clustered
    # matrix (two 128-column blocks a block-row, three entries a row in
    # each) and the non-finite case.
    nbr = 32
    bc = np.stack([rng.choice(nbr, 2, replace=False) for _ in range(nbr)])
    r = np.repeat(np.arange(nbr * 128), 6)
    c = (np.repeat(bc, 128, axis=0)[:, :, None] * 128
         + rng.integers(0, 128, (nbr * 128, 2, 3))).reshape(-1)
    bsr_cases = {"bsr-clustered": (_csr(r, c, (nbr * 128,) * 2, rng), None),
                 "bsr-nonfinite": nonfinite_case()}
    for name, (S, xn) in bsr_cases.items():
        A = sparse.csr_array(S, dtype=torch.float32, device=dev)
        dA = P.shard_csr(A, mesh, force_all_gather=True)
        x = torch.from_numpy(rng.standard_normal(S.shape[0]).astype(
            np.float32) if xn is None else xn).to(dev)
        before = bsr_ops.bsr_spmv.launches
        yd = P.dist_spmv(dA, D.shard_vector(x, mesh, dA.rows_padded))
        launched = bsr_ops.bsr_spmv.launches - before
        xf = D._all_gather(x, group)
        st = dA.bsr
        xpad = torch.zeros(st.nbc * 128, device=dev)
        xpad[:xf.shape[0]] = xf
        y2d = bsr_ops.bsr_spmv(st, xpad.reshape(-1, 128))
        yp = bsr_ops.bsr_spmv_plain(st, xpad.reshape(-1, 128))
        torch.cuda.synchronize()
        out[name] = {"path": dA.spmv_path, "spmv_launched": launched,
                     "kernel": y2d.reshape(-1)[:S.shape[0]].cpu().numpy(),
                     "plain": yp.reshape(-1)[:S.shape[0]].cpu().numpy(),
                     "dist": yd.full_tensor().cpu().numpy(),
                     "single": (A @ x).cpu().numpy()}
    return out


@pytest.fixture(scope="module")
def dist_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_dist_cases, 1, backend="nccl", timeout=300)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DIST_DIA_CASES))
def test_dist_dia_kernels_on_window(dist_card, case, dtype):
    """The DIA SpMV and SpMM kernels on the distributed window equal their
    plain versions bit for bit, and dist_spmv/dist_spmm equal the
    single-device products; the rows decide the variant."""
    r = dist_card[f"{case}-{dtype}"]
    rows, offsets, holes = DIST_DIA_CASES[case]
    halo = max(abs(o) for o in offsets)
    assert r["halo"] == halo
    assert r["window"] == (rows, rows + 2 * halo)
    assert r["offsets"] == tuple(o + halo for o in offsets)
    assert r["masked"]
    v = 4 if dtype == "float32" else 8
    assert r["variant"] == (rows % v == 0)
    assert r["spmv_launched"] == 1 and r["spmm_launched"] == 1
    assert r["spmv_bitwise"] and r["spmm_bitwise"]
    assert r["dist_vs_single"] and r["dist_spmm_vs_single"]
    # f32 masks the band's holes: inf/NaN in x never reach y.  bf16
    # storage keeps no hole mask (zero-filled, as in the JAX package):
    # 0 * inf there is NaN, in the kernel and its plain version alike.
    assert r["finite"] == (dtype == "float32" or not holes)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bsr-clustered", "bsr-nonfinite"])
def test_dist_bsr_kernel_on_row_block(dist_card, case):
    r = dist_card[case]
    assert r["path"] == "bsr" and r["spmv_launched"] == 1
    assert_same_nonfinite(r["kernel"], r["plain"])
    assert_same_nonfinite(r["dist"], r["single"])


# ---- dist_spgemm and DistGMG on one NCCL rank ---------------------------
#
# The banded product (small integers, so every sum is exact in f32 in
# any order) against the single-device ``A @ A`` through the SpGEMM
# kernel, structure and values bit for bit, and its DIA SpMV (the
# kernel on the window) against the single-device product's; the ESC
# product of a holey Poisson square, 1d-row forced to the all-gather
# and as a 1x1 2-d block, bit for bit with the single-device ESC (one
# rank runs the same ESC on the same entries); DistGMG-CG against the
# single-device GMG-CG of ``apps/gmg.py`` (f32, rtol 1e-5): the same
# iteration count, x within 1e-3 of its norm (the hierarchies associate
# the Galerkin product and estimate rho differently), the DIA kernel
# launched on the fine level.

def _dist_spgemm_gmg_cases(rank, world):
    import importlib

    from legate_sparse_tpu_torch import linalg, parallel as P
    from legate_sparse_tpu_torch.apps import gmg as gmg_app
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    spgemm_mod = importlib.import_module(
        "legate_sparse_tpu_torch.parallel.dist_spgemm")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = P.make_row_mesh()
    rng = np.random.default_rng(43)
    out = {}
    n = 1 << 16
    offsets = [-3, -1, 0, 2, 5]
    # Nonzero small integers: an exact band, and exact sums.
    vals = [rng.choice([-3.0, -2.0, -1.0, 1.0, 2.0, 3.0],
                       n - abs(o)).astype(np.float32) for o in offsets]
    A = sparse.diags(vals, offsets, shape=(n, n), format="csr",
                     dtype=torch.float32, device=dev)
    dA = P.dist_diags(vals, offsets, shape=(n, n), mesh=mesh,
                      dtype=np.float32)
    C1 = A @ A
    before = dia_kernel.dia_spmv.launches
    C = P.dist_spgemm(dA, dA)
    r, c, v = D._local_entries(C)
    x = torch.from_numpy(rng.integers(-3, 4, n).astype(np.float32)).to(dev)
    y = P.dist_spmv(C, D.shard_vector(x, mesh, C.rows_padded)).to_local()
    launched = dia_kernel.dia_spmv.launches - before
    torch.cuda.synchronize()
    out["band"] = {
        "single_path": A.spgemm_path, "dist_path": C.spmv_path,
        "dia": C.dia_data is not None, "launched": launched,
        "indptr": torch.equal(torch.bincount(r, minlength=n),
                              (C1.indptr[1:] - C1.indptr[:-1]).long()),
        "indices": torch.equal(c, C1.indices.long()),
        "data": torch.equal(v, C1.data),
        "spmv": torch.equal(y, C1 @ x)}
    Pp = gmg_app.poisson2D(128, dtype=torch.float32, device=dev)
    C1 = Pp @ Pp
    for name, kw in (("esc-1d", {"force_all_gather": True}),
                     ("esc-2d", {"layout": "2d-block"})):
        dPp = P.shard_csr(Pp, mesh, **kw)
        C = P.dist_spgemm(dPp, dPp)
        r, c, v = D._local_entries(C) if C.grid is None else (
            C.row_ids[:int(C.counts)].long(),
            C.cols[:int(C.counts)].long(), C.data[:int(C.counts)])
        torch.cuda.synchronize()
        out[name] = {
            "realization": spgemm_mod.last_b_realization()[0],
            "grid": C.grid, "single_path": Pp.spgemm_path,
            "indptr": torch.equal(torch.bincount(r, minlength=Pp.shape[0]),
                                  (C1.indptr[1:] - C1.indptr[:-1]).long()),
            "indices": torch.equal(c, C1.indices.long()),
            "data": torch.equal(v, C1.data)}
    N = 64
    sol = gmg_app.solve(N, 4, gridop="linear", tol=1e-5, dtype=torch.float32,
                        device=dev)
    Ag = gmg_app.poisson2D(N, dtype=torch.float32, device=dev)
    dG = P.shard_csr(Ag, mesh)
    mg = P.DistGMG(dG, levels=4, gridop="linear")
    b = torch.from_numpy(np.random.default_rng(0).random(N * N)).to(
        dev, torch.float32)
    before = dia_kernel.dia_spmv.launches
    xd, it = P.dist_cg(dG, b, rtol=1e-5, maxiter=200, M=mg.cycle)
    launched = dia_kernel.dia_spmv.launches - before
    xs = sol["x"]
    torch.cuda.synchronize()
    out["gmg"] = {"iters": (it, sol["iters"]), "fine_path": dG.spmv_path,
                  "launched": launched,
                  "err": float((xd.to_local() - xs).norm() / xs.norm())}
    return out


@pytest.fixture(scope="module")
def spgemm_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_dist_spgemm_gmg_cases, 1, backend="nccl",
                     timeout=300)[0]


@pytest.mark.gpu
def test_dist_band_spgemm_on_card(spgemm_card):
    r = spgemm_card["band"]
    assert r["single_path"] == "dia-kernel" and r["dia"]
    assert r["indptr"] and r["indices"] and r["data"]
    assert r["dist_path"] == "dia-kernel" and r["launched"] == 1
    assert r["spmv"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["esc-1d", "esc-2d"])
def test_dist_esc_spgemm_on_card(spgemm_card, name):
    r = spgemm_card[name]
    assert r["single_path"] == "esc"
    assert r["grid"] == (None if name == "esc-1d" else (1, 1))
    if name == "esc-1d":
        assert r["realization"] == "all_gather"
    assert r["indptr"] and r["indices"] and r["data"]


@pytest.mark.gpu
def test_dist_gmg_cg_on_card(spgemm_card):
    r = spgemm_card["gmg"]
    assert r["iters"][0] == r["iters"][1]
    assert r["fine_path"] == "dia-kernel" and r["launched"] > 0
    assert r["err"] <= 1e-3, r["err"]


# ---- more than one card: the collectives across NCCL ranks ---------------
#
# One NCCL rank a card (two, then every visible card; skipped with fewer
# than two):
# each route of dist_spmv/dist_spmm with its real collectives (the halo
# exchange between neighbours, the all-gather, the precise plan's
# all-to-all, the 2-d chunk transpose, panel all-gather and
# reduce-scatter on a 2 x (cards / 2) grid) and dist_cg, each against
# the single-card product or solve that every rank also computes: the
# DIA routes bit for bit, the others within 1e-5 (f32).

def _multi_card_cases(rank, world):
    from legate_sparse_tpu_torch import parallel as P
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(41)
    grid = 512
    n = grid * grid
    main = np.full(n, 4.0, np.float32)
    p1 = np.full(n - 1, -1.0, np.float32)
    p1[np.arange(1, grid) * grid - 1] = 0.0
    pN = np.full(n - grid, -1.0, np.float32)
    S = sp.diags([main, p1, p1, pN, pN], [0, 1, -1, grid, -grid],
                 format="csr")
    S.eliminate_zeros()
    A = sparse.csr_array(S, dtype=torch.float32, device=dev)
    nbr = n // 128
    bc = np.stack([rng.choice(nbr, 4, replace=False) for _ in range(nbr)])
    r = np.repeat(np.arange(n), 8)
    c = (np.repeat(bc, 128, axis=0)[:, :, None] * 128
         + rng.integers(0, 128, (n, 4, 2))).reshape(-1)
    R = sparse.csr_array(_csr(r, c, (n, n), rng), dtype=torch.float32,
                         device=dev)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    X = torch.from_numpy(rng.standard_normal((n, 8)).astype(
        np.float32)).to(dev)
    row, grid_mesh = P.make_row_mesh(), P.make_grid_mesh(2, world // 2)
    out = {}

    def spmv(name, M, mesh, **kw):
        dM = P.shard_csr(M, mesh, **kw)
        xs = D.shard_vector(x, dM.mesh, dM.rows_padded, layout=dM.layout)
        before = {k: f.launches for k, f in (
            ("dia", dia_kernel.dia_spmv), ("bsr", bsr_ops.bsr_spmv))}
        y = P.dist_spmv(dM, xs).full_tensor()
        out[name] = {"path": dM.spmv_path, "halo": dM.halo,
                     "launched": {"dia": dia_kernel.dia_spmv.launches
                                  - before["dia"],
                                  "bsr": bsr_ops.bsr_spmv.launches
                                  - before["bsr"]},
                     "same": _same(y, M @ x),
                     "err": float((y - M @ x).abs().max()
                                  / (M @ x).abs().max())}
        return dM

    dA = spmv("halo", A, row)
    spmv("precise", A, row, precise=True)
    spmv("all-gather", A, row, force_all_gather=True)
    spmv("bsr", R, row, force_all_gather=True)
    spmv("2d-block", R, grid_mesh, layout="2d-block")
    dG = spmv("grid-1d-row", A, grid_mesh)
    for name, dM in (("halo", dA), ("grid-1d-row", dG)):
        Y = P.dist_spmm(dM, P.shard_dense(X, dM.mesh, dM.rows_padded))
        Yf = Y.full_tensor()[:, :8]
        out[name]["spmm_same"] = _same(Yf, A @ X)
    b = torch.ones(n, device=dev)
    xd, itd = P.dist_cg(dA, b, rtol=0.0, maxiter=200)
    xc, itc = sparse.linalg.cg(A, b, rtol=0.0, maxiter=200)
    out["cg"] = {"iters": (itd, itc), "err": float(
        (xd.full_tensor() - xc).norm() / xc.norm())}
    # dist_spgemm: the banded product (its halo exchange) of the exact
    # band dist_poisson2d stores, against scipy's f64 product; the ESC
    # of a holey upper bidiagonal, whose window rotations bring the next
    # row block at three ranks and more, against the single-card ESC.
    import importlib

    spgemm_mod = importlib.import_module(
        "legate_sparse_tpu_torch.parallel.dist_spgemm")
    dB = P.dist_poisson2d(grid, mesh=row, dtype=np.float32)
    SB = dB.to_csr().toscipy().astype(np.float64)
    SC = P.dist_spgemm(dB, dB).to_csr().toscipy()
    out["band-spgemm"] = {"err": float(abs(SC - SB @ SB).max())}
    d0 = rng.standard_normal(n).astype(np.float32)
    d0[::3] = 0.0
    H = sp.diags([d0, rng.standard_normal(n - 1).astype(np.float32)],
                 [0, 1], format="csr")
    H.eliminate_zeros()
    Hc = sparse.csr_array(H, dtype=torch.float32, device=dev)
    dH = P.shard_csr(Hc, row)
    C = P.dist_spgemm(dH, dH)
    real = spgemm_mod.last_b_realization()[0]
    S1, SC = (Hc @ Hc).toscipy(), C.to_csr().toscipy()
    out["esc-spgemm"] = {
        "realization": real,
        "same_structure": bool(np.array_equal(S1.indptr, SC.indptr)
                               and np.array_equal(S1.indices, SC.indices)),
        "err": float(np.abs(S1.data - SC.data).max()
                     / np.abs(S1.data).max())}
    # reshard_vector onto the placement rotated by one rank, and back.
    from torch.distributed.device_mesh import DeviceMesh

    rot = DeviceMesh("cuda", list(range(1, world)) + [0],
                     mesh_dim_names=("rows",))
    xs = D.shard_vector(x, row, n)
    w = P.reshard_vector(xs, rot)
    L = n // world
    c = (rank - 1) % world          # rank r holds chunk r - 1 there
    back = P.reshard_vector(w, row)
    out["reshard"] = {"chunk": bool(torch.equal(w.to_local(),
                                                x[c * L:(c + 1) * L])),
                      "back": bool(torch.equal(back.to_local(),
                                               xs.to_local()))}
    torch.cuda.synchronize()
    return out if rank == 0 else None


@pytest.mark.gpu
def test_dist_nccl_ranks_match_one_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more (one NCCL rank a card)")
    from legate_sparse_tpu_torch.ops import _build
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    _build.build_all()
    # Two ranks (both halo messages go to one peer), then every card.
    for world in sorted({2, torch.cuda.device_count() // 2 * 2}):
        r = run_ranks(_multi_card_cases, world, backend="nccl",
                      timeout=300)[0]
        halo = r["halo"]
        assert halo["path"] == "dia-kernel" and halo["halo"] == 512, world
        for name in ("halo", "grid-1d-row"):
            assert r[name]["same"] and r[name]["spmm_same"], (world, name)
            assert r[name]["launched"]["dia"] == 1, (world, name)
        assert r["bsr"]["path"] == "bsr", world
        assert r["bsr"]["launched"]["bsr"] == 1, world
        for name in ("precise", "all-gather", "bsr", "2d-block"):
            assert r[name]["err"] <= 1e-5, (world, name, r[name])
        assert r["precise"]["path"] == "ell", world
        assert r["2d-block"]["path"] == "2d-block", world
        assert r["cg"]["iters"] == (200, 200), world
        assert r["cg"]["err"] <= 1e-4, world
        band = r["band-spgemm"]
        assert band["err"] <= 1e-5, (world, band)
        esc = r["esc-spgemm"]
        assert esc["realization"] == ("window" if world >= 3
                                      else "all_gather"), world
        assert esc["same_structure"] and esc["err"] <= 1e-6, (world, esc)
        assert r["reshard"]["chunk"] and r["reshard"]["back"], world


# ------------------------------------------------- graph and delta layers --

def _graph_case(n=512, seed=3):
    rng = np.random.default_rng(seed)
    S = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    S.data[:] = rng.uniform(0.5, 2.0, S.nnz)
    return S, rng.uniform(0, 1, n)


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", ["plus-times", "min-plus", "max-times",
                                      "or-and"])
@pytest.mark.parametrize("kernel", ["semiring-csr", "semiring-ell",
                                    "semiring-sliced-ell"])
def test_semiring_matvec_on_card(cuda, semiring, kernel):
    """``graph.matvec`` on the card equal to the same call on the CPU:
    min, max and or bit for bit (order-free reductions), plus-times
    within 1e-12 (its sums meet in another order)."""
    from legate_sparse_tpu_torch import graph

    S, x = _graph_case()
    v = torch.from_numpy(x > 0.5 if semiring == "or-and" else x)
    got = graph.matvec(sparse.csr_array(S, device=cuda), v.to(cuda),
                       semiring=semiring, kernel=kernel)
    want = graph.matvec(sparse.csr_array(S, device="cpu"), v,
                        semiring=semiring, kernel=kernel)
    assert got.device.type == cuda.type and got.dtype == want.dtype
    if semiring == "plus-times":
        torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=1e-12)
    else:
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_delta_on_card(cuda):
    """``DeltaCSR`` on a band on the card: the empty buffer is ``A @ x``
    bit for bit through one ``dia_spmv`` launch; after a stream of
    updates the two-term product is the CPU run's within 1e-6 of
    ``|A'| |x|``, and compaction is the CPU run's base bit for bit."""
    from legate_sparse_tpu_torch import gallery
    from legate_sparse_tpu_torch.delta import DeltaCSR
    from legate_sparse_tpu_torch.settings import settings

    n = 4096
    rng = np.random.default_rng(12)
    S = sp.diags([rng.standard_normal(n - abs(o)).astype(np.float32)
                  for o in (-2, 0, 1)], [-2, 0, 1], format="csr")
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    saved = settings.delta
    settings.delta = True
    try:
        D = DeltaCSR(sparse.csr_array(S, device=cuda))
        H = DeltaCSR(sparse.csr_array(S, device="cpu"))
        xc = x.to(cuda)
        dia_kernel.dia_spmv.launches = 0
        y0 = D.dot(xc)
        assert dia_kernel.dia_spmv.launches == 1
        assert D.base.spmv_path == "dia-kernel"
        assert torch.equal(y0, D.base @ xc)
        for rows, cols, vals in gallery.mutation_stream(4, H.base, 96,
                                                        batch=32):
            D.update(rows, cols, vals)
            H.update(rows, cols, vals)
        y, yh = D.dot(xc).cpu(), H.dot(x)
        mag = np.abs(S.toarray()) @ np.abs(x.numpy()) + 1.0
        assert np.all(np.abs((y - yh).numpy()) <= 1e-6 * mag)
        pending = H.pending
        assert D.pending == pending > 0
        assert D.compact() == H.compact() == pending
        for a, b in ((D.base.data, H.base.data),
                     (D.base.indices, H.base.indices),
                     (D.base.indptr, H.base.indptr)):
            assert torch.equal(a.cpu(), b)
    finally:
        settings.delta = saved


@pytest.mark.gpu
def test_mutation_stream_on_card(cuda):
    """The stream over a matrix on the card is the stream over the same
    matrix on the CPU."""
    from legate_sparse_tpu_torch import gallery

    G = gallery.rmat(10, nnz_per_row=8, rng=5, device="cpu")
    Gc = sparse.csr_array(G, device=cuda)
    for a, b in zip(gallery.mutation_stream(9, Gc, 200, batch=50),
                    gallery.mutation_stream(9, G, 200, batch=50)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def engine_dist_ledger_rank(rank, world):
    """Two banded matrices of one layout on one mesh through
    ``Engine.dist_matvec`` on the CPU: the plan-ledger counts of the
    pair (``test_torch_engine.py``: the second is a hit).  It lives here
    because a rank imports the module of its function, and this one
    imports no JAX."""
    from legate_sparse_tpu_torch import obs, parallel, runtime
    from legate_sparse_tpu_torch.engine import Engine
    from legate_sparse_tpu_torch.parallel.dist_csr import shard_vector

    runtime.set_device("cpu")
    n = 1 << 10
    mesh = parallel.make_row_mesh()

    def banded(seed):
        rng = np.random.default_rng(seed)
        return sparse.csr_array(sp.diags(
            [rng.standard_normal(n - 1).astype(np.float32),
             np.full(n, 4.0, np.float32),
             rng.standard_normal(n - 1).astype(np.float32)],
            [-1, 0, 1], format="csr", dtype=np.float32))

    dA1 = parallel.shard_csr(banded(1), mesh=mesh)
    dA2 = parallel.shard_csr(banded(2), mesh=mesh)
    x = shard_vector(np.ones(n, np.float32), mesh, dA1.rows_padded)
    eng = Engine()
    m0, h0 = (obs.counters.get("engine.plan.misses"),
              obs.counters.get("engine.plan.hits"))
    y1 = eng.dist_matvec(dA1, x)
    m1 = obs.counters.get("engine.plan.misses") - m0
    eng.dist_matvec(dA2, x)
    return {"miss_after_first": m1,
            "misses": obs.counters.get("engine.plan.misses") - m0,
            "hits": obs.counters.get("engine.plan.hits") - h0,
            "y": y1.full_tensor()[:n].numpy()}


# ---- the serving path on the card (engine, executor, gateway) ------------


def engine_style(n, nnz_per_row=11, seed=7):
    """The bench's engine matrix: random columns, one heavy row of
    ``64 * nnz_per_row`` (it breaks the ELL and BSR budgets), nnz =
    nnz_per_row * (n + 63); seeds share one shape bucket."""
    rng = np.random.default_rng(seed)
    counts = np.full(n, nnz_per_row, dtype=np.int64)
    counts[0] = min(64 * nnz_per_row, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, n, size=nnz).astype(np.int32)
    order = np.lexsort((indices, np.repeat(np.arange(n), counts)))
    data = rng.standard_normal(nnz).astype(np.float32)
    return sp.csr_matrix((data, indices[order], indptr), shape=(n, n))


def _card_x(n, cuda, dtype=torch.float32, seed=0, k=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = (n,) if k is None else (n, k)
    return torch.randn(shape, device=cuda, dtype=dtype, generator=g)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["rmat", "engine-style"])
def test_csr_rowids_repeat_exactly(cuda, case):
    """csr-rowids sums in a fixed order on the card: ten calls give equal
    bits, on the phase-9 R-MAT (rows past ``SERIAL_MAX_ROW``: the CSR
    kernel's hub rows, in chunks) and on an engine-style matrix (slot
    order); the SpMM's column 0 and the product from counted lengths
    are ``A @ x``'s bits."""
    from legate_sparse_tpu_torch.ops import spmv as spmv_ops

    if case == "rmat":
        A = sparse.rmat(20, nnz_per_row=8, rng=0, device=cuda)
        x = _card_x(A.shape[1], cuda, torch.float64)
    else:
        A = sparse.csr_array(engine_style((1 << 20) - 91), device=cuda)
        x = _card_x(A.shape[1], cuda)
    assert A._serial_rows() == (case != "rmat")
    ys = [A @ x for _ in range(10)]
    assert A.spmv_path == "csr-rowids"
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    X = torch.stack([x, 2 * x, -x], dim=1)
    Ys = [A @ X for _ in range(3)]
    assert A.spmm_path == "csr-rowids"
    assert all(torch.equal(Ys[0], Y) for Y in Ys[1:])
    assert torch.equal(Ys[0][:, 0], ys[0])
    direct = spmv_ops.csr_spmv_rowids(A.data, A.indices, A._get_row_ids(),
                                      x, A.shape[0])
    assert torch.equal(direct, ys[0])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["rmat", "engine-style"])
def test_engine_plan_bitwise_csr_rowids_on_card(cuda, case):
    """The bucketed plan (padded pack, padding segments dropped) is bit
    for bit the unpadded csr-rowids product, SpMV and SpMM."""
    from legate_sparse_tpu_torch.engine import Engine

    if case == "rmat":
        A = sparse.rmat(16, nnz_per_row=8, rng=0, device=cuda)
        dt = torch.float64
    else:
        A = sparse.csr_array(engine_style((1 << 16) - 91), device=cuda)
        dt = torch.float32
    x = _card_x(A.shape[1], cuda, dt)
    X = _card_x(A.shape[1], cuda, dt, seed=1, k=3)
    eng = Engine()
    assert torch.equal(eng.matvec(A, x), A @ x)
    assert A.spmv_path == "csr-rowids"
    assert torch.equal(eng.matmat(A, X), A @ X)


@pytest.mark.gpu
def test_multi_matvec_on_card(cuda):
    """Matrices of one bucket in one stacked dispatch: each result bit
    for bit its own plan's."""
    from legate_sparse_tpu_torch.engine import Engine

    n = (1 << 16) - 91
    mats = [sparse.csr_array(engine_style(n, seed=s), device=cuda)
            for s in (7, 13, 29)]
    mats.append(sparse.csr_array(engine_style((1 << 16) - 37), device=cuda))
    xs = [_card_x(M.shape[1], cuda, seed=i) for i, M in enumerate(mats)]
    eng = Engine()
    ys = eng.multi_matvec(list(zip(mats, xs)))
    assert ys is not None
    for y, M, x in zip(ys, mats, xs):
        assert torch.equal(y, eng.matvec(M, x))


@pytest.mark.gpu
def test_engine_packs_build_the_csr_schedule_once(cuda, monkeypatch):
    """Each engine pack builds the CSR kernel's schedule once, with no
    chunk table for a matrix whose rows sum one thread a row; warm
    requests and a stacked batch build none, a request launches the
    kernel once and a batch once a real matrix, each result bit for bit
    its own plan's."""
    from legate_sparse_tpu_torch.engine import Engine

    built = []
    real = csr_kernel.build_schedule

    def counted(*args, **kwargs):
        built.append(kwargs.get("hubs", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(csr_kernel, "build_schedule", counted)
    n = (1 << 16) - 91
    mats = [sparse.csr_array(engine_style(n, seed=s), device=cuda)
            for s in (7, 13, 29)]
    xs = [_card_x(n, cuda, seed=i) for i in range(3)]
    eng = Engine()
    for M, x in zip(mats, xs):
        eng.matvec(M, x)
    assert built == [False] * 3
    before = csr_kernel.csr_spmv.launches
    ys = [eng.matvec(M, x) for M, x in zip(mats, xs)]
    assert csr_kernel.csr_spmv.launches == before + 3
    batch = eng.multi_matvec(list(zip(mats, xs)))
    assert csr_kernel.csr_spmv.launches == before + 6
    assert built == [False] * 3
    for y, yb in zip(ys, batch):
        assert torch.equal(y, yb)


@pytest.mark.gpu
def test_stacked_spmm_columns_on_card(cuda):
    """Eight requests on one matrix become one stacked SpMM whose every
    column is bit for bit the single dispatch."""
    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.engine import Engine, RequestExecutor

    A = sparse.csr_array(engine_style((1 << 16) - 91), device=cuda)
    eng = Engine()
    ex = RequestExecutor(eng, max_batch=8, queue_depth=64, timeout_ms=0)
    b0 = obs.counters.get("engine.exec.batches")
    try:
        xs = [_card_x(A.shape[1], cuda, seed=i) for i in range(8)]
        futs = [ex.submit(A, x) for x in xs]
        ys = [f.result(timeout=60) for f in futs]
    finally:
        ex.shutdown()
    assert obs.counters.get("engine.exec.batches") == b0 + 1
    for y, x in zip(ys, xs):
        assert torch.equal(y, eng.matvec(A, x))


@pytest.mark.gpu
def test_gateway_inline_kernels_on_card(cuda):
    """The gateway serves a banded and a block matrix inline through
    ``A.dot``, which launches the DIA and BSR kernels: bit for bit."""
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.settings import settings

    rng = np.random.default_rng(1)
    S = _holey(1 << 16, rng)
    D = sparse.csr_array(S, device=cuda)
    R = sparse.csr_array(sp.random(4096, 4096, density=0.01, format="csr",
                                   random_state=rng, dtype=np.float32),
                         device=cuda)
    saved = settings.gateway
    settings.gateway = True
    gw = Gateway(Engine(), max_batch=8, timeout_ms=0.0)
    try:
        d0, b0 = dia_kernel.dia_spmv.launches, bsr_ops.bsr_spmv.launches
        xd, xr = _card_x(D.shape[1], cuda), _card_x(R.shape[1], cuda)
        yd = gw.submit(D, xd, tenant="banded").result(timeout=60)
        yr = gw.submit(R, xr, tenant="blocks").result(timeout=60)
        assert dia_kernel.dia_spmv.launches == d0 + 1
        assert bsr_ops.bsr_spmv.launches == b0 + 1
    finally:
        gw.shutdown()
        settings.gateway = saved
    assert torch.equal(yd, D @ xd) and D.spmv_path == "dia-kernel"
    assert torch.equal(yr, R @ xr) and R.spmv_path == "bsr"


# ------------------------------------------------------------ resilience --

def _poisson_card(grid, device):
    n = grid * grid
    p1 = np.full(n - 1, -1.0, np.float32)
    p1[np.arange(1, grid) * grid - 1] = 0.0
    pN = np.full(n - grid, -1.0, np.float32)
    return sparse.diags([np.full(n, 4.0, np.float32), p1, p1, pN, pN],
                        [0, 1, -1, grid, -grid], shape=(n, n), format="csr",
                        dtype=torch.float32, device=device)


def _resil_on(settings):
    saved = {k: getattr(settings, k) for k in (
        "resil", "resil_backoff_ms", "resil_health", "resil_abft")}
    settings.resil = True
    settings.resil_backoff_ms = 0.0
    return saved


@pytest.mark.gpu
def test_resilient_cg_bitwise_on_card(cuda):
    """CG in its resilient stretches (deadline, health and a checkpoint
    scope) is bit for bit the plain CG on the card: the same iterate,
    iterations, host fetches and DIA launches; one injected error at
    ``solver.cg.conv`` is retried and still bit for bit."""
    from legate_sparse_tpu_torch import linalg, obs, resilience
    from legate_sparse_tpu_torch.settings import settings

    A = _poisson_card(128, cuda)
    b = torch.ones(A.shape[0], device=cuda)
    key = "transfer.host_sync.cg_conv"

    def solve():
        s0, d0 = obs.counters.get(key), dia_kernel.dia_spmv.launches
        x, it = linalg.cg(A, b, rtol=0.0, maxiter=100)
        return x, it, obs.counters.get(key) - s0, \
            dia_kernel.dia_spmv.launches - d0

    x0, it0, s0, d0 = solve()
    assert A.spmv_path == "dia-kernel" and d0 == it0 + 1
    saved = _resil_on(settings)
    settings.resil_health = True
    resilience.reset()
    try:
        with resilience.deadline.scope(600_000.0), \
                resilience.checkpoint.scope("t", every=25) as ck:
            x1, it1, s1, d1 = solve()
        assert ck.saves == 4 and isinstance(ck.arrays[0], np.ndarray)
        resilience.inject("solver.cg.conv", kind="error", count=1)
        with resilience.deadline.scope(600_000.0):
            x2, it2, _s2, _d2 = solve()
        assert resilience.faults.fired("solver.cg.conv") == 1
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        resilience.reset()
    assert (it1, s1, d1) == (it0, s0, d0)
    assert it2 == it0
    assert torch.equal(x1, x0) and torch.equal(x2, x0)


def _resil_rank(rank, world):
    from legate_sparse_tpu_torch import obs, parallel as P, resilience
    from legate_sparse_tpu_torch.parallel.dist_csr import shard_vector
    from legate_sparse_tpu_torch.settings import settings

    dev = torch.device("cuda", torch.cuda.current_device())
    dA = P.shard_csr(_poisson_card(128, dev))
    x = shard_vector(torch.randn(dA.shape[0], device=dev,
                                 generator=torch.Generator(dev)
                                 .manual_seed(7)), dA.mesh, dA.rows_padded)
    plain = P.dist_spmv(dA, x).to_local().clone()
    saved = _resil_on(settings)
    settings.resil_abft = True
    resilience.reset()
    out = {}
    try:
        c0 = obs.counters.snapshot("resil.")
        d0 = dia_kernel.dia_spmv.launches
        y = P.dist_spmv(dA, x).to_local()
        c1 = obs.counters.snapshot("resil.")
        resilience.inject("dist.spmv.abft", kind="nonfinite", count=1)
        y2 = P.dist_spmv(dA, x).to_local()
        c2 = obs.counters.snapshot("resil.")
        out["abft"] = {
            "path": dA.spmv_path, "launches": dia_kernel.dia_spmv.launches
            - d0, "clean": bool(torch.equal(y, plain)),
            "retried": bool(torch.equal(y2, plain)),
            "checks": c1.get("resil.abft.checks", 0)
            - c0.get("resil.abft.checks", 0),
            "mismatch": c2.get("resil.abft.mismatch", 0)
            - c1.get("resil.abft.mismatch", 0),
            "retries": c2.get("resil.retry.dist.spmv", 0)
            - c1.get("resil.retry.dist.spmv", 0)}
        resilience.reset()
        a0 = obs.counters.get("resil.recovery.attempts")
        resilience.inject("solver.cg.conv", "device_loss", after=1)
        try:
            with resilience.checkpoint.scope("dist.cg", every=25):
                P.dist_cg(dA, np.ones(dA.shape[0], np.float32), rtol=0.0,
                          maxiter=100)
            out["loss"] = "returned"
        except resilience.DeviceLost:
            out["loss"] = ("raised",
                           obs.counters.get("resil.recovery.attempts") - a0)
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        resilience.reset()
    torch.cuda.synchronize()
    return out


@pytest.fixture(scope="module")
def resil_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_resil_rank, 1, backend="nccl", timeout=300)[0]


@pytest.mark.gpu
def test_abft_on_card(resil_card):
    """The ABFT-checked ``dist_spmv`` through the DIA kernel on the
    window: a clean pass counts one check; a poisoned y is one
    mismatch and one retry, and the result the clean one bit for bit."""
    a = resil_card["abft"]
    assert a["path"] == "dia-kernel" and a["launches"] == 3
    assert a["clean"] and a["retried"]
    assert (a["checks"], a["mismatch"], a["retries"]) == (1, 1, 1)


@pytest.mark.gpu
def test_device_loss_at_one_rank_reraises_on_card(resil_card):
    assert resil_card["loss"] == ("raised", 0)


def _ladder_rank(rank, world):
    import torch.distributed as dist

    from legate_sparse_tpu_torch import obs, parallel as P, resilience
    from legate_sparse_tpu_torch.settings import settings

    dev = torch.device("cuda", torch.cuda.current_device())
    dA = P.shard_csr(_poisson_card(64, dev))
    b = np.ones(dA.shape[0], np.float32)
    saved = _resil_on(settings)
    resilience.reset()
    out = {"rank": rank}
    try:
        resilience.inject("solver.cg.conv", "device_loss", after=2,
                          device=1)
        c0 = obs.counters.snapshot("resil.")
        try:
            with resilience.checkpoint.scope("dist.cg", every=25):
                x, it = P.dist_cg(dA, b, rtol=0.0, maxiter=200)
            out["iters"] = int(it)
            out["x"] = x.full_tensor().cpu().numpy()
            out["path"] = dA.spmv_path
        except resilience.DeviceLost:
            out["lost"] = True
        c1 = obs.counters.snapshot("resil.")
        out["moved"] = {k: c1[k] - c0.get(k, 0) for k in c1
                        if k.startswith("resil.recovery.")
                        and c1[k] != c0.get(k, 0)}
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        resilience.reset()
    torch.cuda.synchronize()
    dist.barrier()
    return out


@pytest.mark.gpu
def test_recovery_ladder_nccl_ranks():
    """``dist_cg`` at 2 NCCL ranks loses rank 1 at its third fetch: rank
    0 recovers alone (one recovery, 50 iterations restored, 200 in all)
    and matches scipy; rank 1 leaves with ``DeviceLost``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more (one NCCL rank a card)")
    import scipy.sparse.linalg as spla

    from legate_sparse_tpu_torch.ops import _build
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    _build.build_all()
    r0, r1 = run_ranks(_ladder_rank, 2, backend="nccl", timeout=300)
    assert r1.get("lost") and not r1["moved"]
    assert r0["iters"] == 200
    assert r0["moved"]["resil.recovery.attempts"] == 1
    assert r0["moved"]["resil.recovery.restored_iters"] == 50
    assert r0["moved"]["resil.recovery.succeeded"] == 1
    grid = 64
    n = grid * grid
    p1 = np.full(n - 1, -1.0)
    p1[np.arange(1, grid) * grid - 1] = 0.0
    S = sp.diags([np.full(n, 4.0), p1, p1, np.full(n - grid, -1.0),
                  np.full(n - grid, -1.0)], [0, 1, -1, grid, -grid],
                 format="csc")
    ref = spla.spsolve(S, np.ones(n))
    assert np.linalg.norm(r0["x"] - ref) <= 1e-4 * np.linalg.norm(ref)


# ---------------------------------------------------- the operations layer --

def _ops_matrices(cuda, rng):
    D = sparse.csr_array(_holey(1 << 16, rng), device=cuda)
    R = sparse.csr_array(sp.random(4096, 4096, density=0.01, format="csr",
                                   random_state=rng, dtype=np.float32),
                         device=cuda)
    return D, R


@pytest.mark.gpu
def test_placed_dot_matches_unplaced_on_card(cuda):
    """A placed tenant on a one-card slice serves through its matrix's own
    kernel: the handle's ``dot`` (directly and through the gateway with
    placement on) launches ``dia_spmv``/``bsr_spmv`` once a request and
    is bit for bit the unplaced ``A.dot``."""
    from legate_sparse_tpu_torch import placement
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.settings import settings

    rng = np.random.default_rng(2)
    D, R = _ops_matrices(cuda, rng)
    saved = (settings.gateway, settings.placement)
    settings.gateway = settings.placement = True
    gw = Gateway(Engine(), max_batch=8, timeout_ms=0.0)
    try:
        for name, A, route in (("banded", D, "dia-kernel"),
                               ("blocks", R, "bsr")):
            placement.place(name, A)
            assert placement.migrate_to(name, 1) > 0
            x = _card_x(A.shape[1], cuda)
            ref = A @ x
            assert A.spmv_path == route
            before = _launches()
            y = placement.route(A, name).dot(x)
            yg = gw.submit(A, x, tenant=name).result(timeout=60)
            moved = [b - a for a, b in zip(before, _launches())]
            assert moved == ([2, 0, 0, 0, 0, 0] if route == "dia-kernel"
                             else [0, 0, 2, 0, 0, 0])
            assert torch.equal(y, ref) and torch.equal(yg, ref)
    finally:
        gw.shutdown()
        placement.reset()
        settings.gateway, settings.placement = saved


@pytest.mark.gpu
def test_attribution_on_off_same_bits_on_card(cuda):
    """The gateway load (a banded and a block tenant inline, a packed
    engine pair) with attribution and SLOs off, then on: the same bits,
    and on, the tenants' wall time sums to the dispatch spans'."""
    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.settings import settings

    rng = np.random.default_rng(3)
    D, R = _ops_matrices(cuda, rng)
    E = sparse.csr_array(sp.random(2048, 2048, density=0.002, format="csr",
                                   random_state=rng, dtype=np.float32),
                         device=cuda)
    xs = {A.shape[1]: _card_x(A.shape[1], cuda) for A in (D, R, E)}
    saved = (settings.gateway, settings.obs_attrib, settings.obs_slo)

    def load():
        gw = Gateway(Engine(), max_batch=8, timeout_ms=0.0)
        try:
            futs = [gw.submit(A, xs[A.shape[1]], tenant=t, qos=q)
                    for A, t, q in ((D, "banded", "interactive"),
                                    (R, "blocks", "batch"),
                                    (E, "alpha", "interactive"),
                                    (E, "beta", "batch"))]
            gw.flush()
            return [f.result(timeout=60) for f in futs]
        finally:
            gw.shutdown()

    settings.gateway = True
    obs.reset_all()
    obs.enable()
    try:
        off = load()
        assert not obs.counters.snapshot("attrib.")
        obs.reset_all()
        settings.obs_attrib = settings.obs_slo = True
        on = load()
        spans = sum(r["dur_ns"] for r in obs.records()
                    if r.get("type") == "span"
                    and r["name"] in obs.attrib.DISPATCH_SPANS)
        wall = sum(v for k, v in obs.counters.snapshot(
            "attrib.tenant.").items() if k.endswith(".wall_ns"))
    finally:
        obs.disable()
        obs.reset_all()
        settings.gateway, settings.obs_attrib, settings.obs_slo = saved
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert wall == spans > 0


def _submesh_rank(rank, world):
    """A banded tenant migrated onto ranks 0-1 of a job of ``world``
    NCCL ranks: the slice's ranks serve through ``dist_spmv`` (the DIA
    kernel on each window), bit for bit the one-card product; a rank
    outside the slice makes no collective."""
    from legate_sparse_tpu_torch import placement
    from utils_test.torch_ops_ranks import CollectiveMeter

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(4)
    A = sparse.csr_array(_holey(1 << 16, rng), device=dev)
    x = _card_x(A.shape[1], dev)
    ref = A @ x
    placement.place("banded", A)
    placement.migrate_to("banded", 2)
    h = placement.route(A, "banded")
    d0 = dia_kernel.dia_spmv.launches
    with CollectiveMeter() as meter:
        y = h.dot(x)
    torch.cuda.synchronize()
    out = {"member": h._dist is not None, "calls": meter.calls,
           "same": bool(torch.equal(y, ref)),
           "launches": dia_kernel.dia_spmv.launches - d0}
    placement.reset()
    torch.distributed.barrier()
    return out


@pytest.mark.gpu
def test_placement_submesh_nccl_ranks():
    """A tenant on a 2-rank submesh of a job over every card (up to 4):
    the slice's ranks' product bit for bit the one-card one, through the
    DIA kernel; ranks outside the slice serve locally with no
    collective."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more (one NCCL rank a card)")
    from legate_sparse_tpu_torch.ops import _build
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    _build.build_all()
    world = min(torch.cuda.device_count(), 4)
    res = run_ranks(_submesh_rank, world, backend="nccl", timeout=300)
    for rank, r in enumerate(res):
        assert r["same"] and r["launches"] >= 1
        assert r["member"] == (rank < 2)
        assert (r["calls"] > 0) if rank < 2 else (r["calls"] == 0)


# ---- the entry points' timing (bench_timing, apps.common) ------------------


@pytest.mark.gpu
def test_bench_timing_on_card(cuda):
    """``time_ms`` (CUDA events) and ``loop_ms_per_iter`` (synchronised
    trip counts) give positive, finite times on the card."""
    from legate_sparse_tpu_torch.bench_timing import (loop_ms_per_iter,
                                                      time_ms)

    x = torch.ones(1 << 22, dtype=torch.float32, device=cuda)
    ms = time_ms(lambda: x.mul(1.0000001), reps=5)
    assert np.isfinite(ms) and ms > 0
    per_iter = loop_ms_per_iter(lambda v: v * 1.0000001, x, k_lo=5, k_hi=50)
    assert np.isfinite(per_iter) and per_iter > 0


@pytest.mark.gpu
def test_triad_below_the_hbm_peak(cuda):
    """A triad over 2^24 lanes cannot move bytes faster than the card's
    3.35 TB/s (data sheet), with 5% for the clocks."""
    from legate_sparse_tpu_torch.bench_timing import triad_gbs

    gbs = triad_gbs(24, device=cuda)
    assert 0 < gbs < 1.05 * 3350.0


@pytest.mark.gpu
def test_app_timer_fences(cuda):
    """``apps.common.TorchTimer`` synchronises at both ends: one timed
    2^24-row SpMV (11 diagonals, f32) takes at least the DIA kernel's
    own time by CUDA events."""
    from legate_sparse_tpu_torch.apps.common import (TorchTimer,
                                                     banded_matrix)
    from legate_sparse_tpu_torch.bench_timing import time_ms

    A = banded_matrix(1 << 24, 11, device=cuda, dtype=torch.float32)
    x = torch.ones(1 << 24, dtype=torch.float32, device=cuda)
    A @ x
    assert A.spmv_path == "dia-kernel"
    kernel_ms = time_ms(lambda: A @ x, reps=5)
    timer = TorchTimer(cuda)
    samples = []
    for _ in range(5):
        timer.start()
        A @ x
        samples.append(timer.stop())
    assert min(samples) >= kernel_ms


@pytest.mark.gpu
def test_app_defaults_reach_the_kernels(cuda):
    """The apps' default dtype on ``cuda`` is float32 (``harness_float``),
    so the documented commands of the SpMV and SpGEMM microbenchmarks run
    the DIA kernels, not their plain twins."""
    from legate_sparse_tpu_torch.apps import common
    from legate_sparse_tpu_torch.apps import spgemm_microbenchmark as spgemm
    from legate_sparse_tpu_torch.apps import spmv_microbenchmark as spmv

    h = common.parse_common_args(["--device", "cuda"])
    assert h.dtype == torch.float32
    recs = spmv.main(["--device", "cuda", "--nmin", "4096", "--nmax",
                      "4096", "-i", "3"])
    assert recs[-1]["path"] == "dia-kernel"
    assert spgemm.run_spgemm(4096, 5, "", "", 2, True, h)["path"] \
        == "dia-kernel"
