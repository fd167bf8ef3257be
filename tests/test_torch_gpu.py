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
(``nonfinite_case``).  The BSR cases are shared with the CPU tests
(``test_torch_bsr.py``, ``test_torch_spmm.py``); the BSR kernels take
int16 column indices (compressed storage) as they take int32 and int64,
and the int16 SpMM agrees with the int32 one bit for bit.
Compressed storage (``csr_array.compress``) against a bf16 operand runs
the bf16 kernels; against an f32 operand it takes the plain widening
routes and launches no kernel.  Spans and latency timers make no device
synchronisation (``torch.profiler`` counts none).
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
    return (dia_kernel.dia_spmv.launches, dia_kernel.dia_spmm.launches,
            bsr_ops.bsr_spmv.launches, bsr_ops.bsr_spmm.launches)


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
    assert _launches() == before[:2] + (before[2] + 1, before[3] + 1)
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
