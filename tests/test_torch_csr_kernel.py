# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The CSR SpMV kernel's route, schedule, plain twin and checks on the CPU.

``ops/spmv.py::csr_spmv_rowids`` sends CPU operands to
``csr_spmv_rowids_plain``, the ops the JAX-parity tests hold, bit for
bit and with no launch; only CUDA operands of the kernel's types reach
``ops/csr_kernel.py``.  The kernel itself runs on the card
(``tests/test_torch_gpu.py``, whose cases this file shares); here its
schedule (``build_schedule``) and its three passes, walked in Python
over that schedule, are held to its plain twin ``csr_spmv_ordered``.
This file imports no JAX.
"""

import re

import numpy as np
import pytest
import torch

from legate_sparse_tpu_torch.ops import _build, csr_kernel
from legate_sparse_tpu_torch.ops import spmv as spmv_ops

from test_torch_gpu import (CSR_KERNEL_HEAD, assert_bitwise,
                            assert_csr_case_rows, csr_f64_reference,
                            csr_kernel_case)

CPU = torch.device("cpu")
C = csr_kernel.CHUNK


def _offsets(lengths):
    out = torch.zeros(len(lengths) + 1, dtype=torch.int64)
    torch.cumsum(torch.tensor(lengths, dtype=torch.int64), 0, out=out[1:])
    return out


def test_ordered_twin_against_f64_scatter():
    """f64 within 1e-12 of the largest |y| of a float64 scatter on the
    class-edge rows; empty and -0.0 rows read +0.0, the NaN of x at an
    unstored column stays out of y."""
    rng = np.random.default_rng(1)
    case = csr_kernel_case(rng, torch.float64, torch.int32, torch.int64,
                           CPU)
    y = csr_kernel.csr_spmv_ordered(*case)
    assert_csr_case_rows(y, case[2])
    ref = csr_f64_reference(*case)
    fin = ref.isfinite()
    assert (y[fin] - ref[fin]).abs().max() <= 1e-12 * ref[fin].abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_twin_is_slot_order_on_a_serial_matrix(dtype):
    """With no row past ``CHUNK`` entries every row sums in slot order:
    the plain ops' one-thread-a-row sums, bit for bit."""
    rng = np.random.default_rng(2)
    lengths = [0, C, 1, 0] + list(rng.integers(0, C + 1, 300)) + [0]
    offsets = _offsets(lengths)
    nnz = int(offsets[-1])
    data = torch.from_numpy(rng.standard_normal(nnz)).to(dtype)
    cols = torch.from_numpy(rng.integers(0, 700, nnz)).to(torch.int32)
    x = torch.from_numpy(rng.standard_normal(700)).to(dtype)
    plain = spmv_ops.csr_spmv_rowids_plain(
        data, cols, None, x, len(lengths), lengths=offsets[1:] - offsets[:-1],
        serial=True)
    assert torch.equal(csr_kernel.csr_spmv_ordered(data, cols, offsets, x),
                       plain)


def test_chunk_covers_the_serial_rows():
    """A matrix the plain ops sum one thread a row (longest row at most
    ``SERIAL_MAX_ROW``) has no hub row, so the kernel keeps its bits."""
    assert csr_kernel.CHUNK >= spmv_ops.SERIAL_MAX_ROW
    assert csr_kernel.TILE <= csr_kernel.CHUNK


def test_schedule_on_hand_made_lengths():
    """Tiles: every tile's rows start in one TILE-slot stretch, at most
    TILE_ROWS of them, a hub row only last, and together they cover the
    rows once.  Chunks: hub rows (past CHUNK) in order, their chunks in
    slot order, sized by ``chunk_bound``, -1 after the last."""
    lengths = [0, 0, C, C + 1, 3, 0, 2 * C + 5, 1] + [0] * 2500 + [C, 0]
    offsets = _offsets(lengths)
    nnz = int(offsets[-1])
    s = csr_kernel.build_schedule(offsets, nnz)
    tr = s.tile_rows.tolist()
    assert tr[0] == 0 and tr[-1] == len(lengths) and tr == sorted(tr)
    assert s.tiles == (nnz // csr_kernel.TILE + 1
                       + -(-len(lengths) // csr_kernel.TILE_ROWS))
    for r0, r1 in zip(tr, tr[1:]):
        if r0 == r1:
            continue
        assert r1 - r0 <= csr_kernel.TILE_ROWS
        starts = offsets[r0:r1]
        assert len(set((starts // csr_kernel.TILE).tolist())) == 1
        assert all(lengths[r] <= C for r in range(r0, r1 - 1))
    assert s.chunk_row.shape[0] == csr_kernel.chunk_bound(nnz)
    live = int((s.chunk_row >= 0).sum())
    assert s.chunk_row[:live].tolist() == [3, 3, 6, 6, 6]
    a3, a6 = int(offsets[3]), int(offsets[6])
    assert s.chunk_start[:live].tolist() == [a3, a3 + C, a6, a6 + C,
                                             a6 + 2 * C]
    assert (s.chunk_row[live:] == -1).all()
    assert (s.chunk_start[live:] == -1).all()
    assert s.host_counts() == (2, 5)


def test_chunk_bound_holds_at_its_worst():
    """Every row a hub row of CHUNK + 1 entries: two chunks a row, and
    the bound still holds them."""
    lengths = [C + 1] * 37
    nnz = sum(lengths)
    s = csr_kernel.build_schedule(_offsets(lengths), nnz)
    assert s.host_counts() == (37, 74)
    assert csr_kernel.chunk_bound(nnz) >= 74
    assert int((s.chunk_row >= 0).sum()) == 74


def test_schedule_without_hubs():
    """``hubs=False`` (no row past CHUNK): the tiles of the full
    schedule, empty chunk tables, and no hub rows or chunks counted."""
    rng = np.random.default_rng(7)
    lengths = [0, C, 1] + list(rng.integers(0, C + 1, 400)) + [0] * 1100
    offsets = _offsets(lengths)
    nnz = int(offsets[-1])
    full = csr_kernel.build_schedule(offsets, nnz)
    bare = csr_kernel.build_schedule(offsets, nnz, hubs=False)
    assert torch.equal(bare.tile_rows, full.tile_rows)
    assert bare.chunk_row.shape == bare.chunk_start.shape == (0,)
    assert bare.host_counts() == full.host_counts() == (0, 0)


def _three_passes(data, cols, offsets, x, hubs=True):
    """The kernel's three passes walked in Python over the schedule:
    chunk sums into partials, tiles' rows in slot order from +0.0
    (hub rows left), hub rows' partials in chunk order."""
    offs = offsets.to(torch.int64)
    s = csr_kernel.build_schedule(offsets, data.shape[0], hubs=hubs)
    y = torch.full((offs.shape[0] - 1,), float("nan"), dtype=data.dtype)
    zero = torch.zeros((), dtype=data.dtype)
    partial = torch.empty(s.chunk_row.shape[0], dtype=data.dtype)
    for k, (row, start) in enumerate(zip(s.chunk_row.tolist(),
                                         s.chunk_start.tolist())):
        if row < 0:
            break
        end = min(start + C, int(offs[row + 1]))
        taken = torch.zeros(C, dtype=data.dtype)
        taken[:end - start] = data[start:end] * x[cols[start:end].long()]
        partial[k] = csr_kernel._chunk_sums(taken[None])[0]
    tr = s.tile_rows.tolist()
    for r0, r1 in zip(tr, tr[1:]):
        if r0 == r1:
            continue
        s0, last, s1 = int(offs[r0]), int(offs[r1 - 1]), int(offs[r1])
        if s1 - last > C:
            s1 = last
        assert s1 - s0 < csr_kernel.TILE + C
        prod = data[s0:s1] * x[cols[s0:s1].long()]
        for r in range(r0, r1):
            a, b = int(offs[r]), int(offs[r + 1])
            if b - a > C:
                assert r == r1 - 1
                continue
            acc = zero
            for j in range(a - s0, b - s0):
                acc = acc + prod[j]
            y[r] = acc
    for k, (row, start) in enumerate(zip(s.chunk_row.tolist(),
                                         s.chunk_start.tolist())):
        if row < 0:
            break
        if start != int(offs[row]):
            continue
        acc = zero
        for i in range(-(-(int(offs[row + 1]) - start) // C)):
            acc = acc + partial[k + i]
        y[row] = acc
    return y


@pytest.mark.parametrize("offset_dtype", [torch.int32, torch.int64])
def test_three_passes_equal_the_ordered_twin(offset_dtype):
    """The kernel's control flow over its schedule, in Python, gives
    ``csr_spmv_ordered``'s bits on the class-edge rows."""
    rng = np.random.default_rng(3)
    case = csr_kernel_case(rng, torch.float32, torch.int32, offset_dtype,
                           CPU, tail=False)
    got = _three_passes(*case)
    assert_bitwise(got, csr_kernel.csr_spmv_ordered(*case))
    assert got.shape[0] == len(CSR_KERNEL_HEAD) + 2


def test_three_passes_without_hubs_on_a_serial_matrix():
    """On a matrix with no row past CHUNK, the tile pass alone over a
    ``hubs=False`` schedule gives the twin's bits, which are slot
    order."""
    rng = np.random.default_rng(8)
    lengths = [0, C, C - 1, 0] + list(rng.integers(0, 60, 500)) + [0]
    offsets = _offsets(lengths)
    nnz = int(offsets[-1])
    data = torch.from_numpy(rng.standard_normal(nnz)).float()
    cols = torch.from_numpy(rng.integers(0, 900, nnz)).to(torch.int32)
    x = torch.from_numpy(rng.standard_normal(900)).float()
    assert_bitwise(_three_passes(data, cols, offsets, x, hubs=False),
                   csr_kernel.csr_spmv_ordered(data, cols, offsets, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.int64])
def test_cpu_route_is_plain_bit_for_bit(dtype):
    """CPU operands take ``csr_spmv_rowids_plain`` (and the SpMM its
    plain ops), whatever their type, and launch nothing."""
    rng = np.random.default_rng(4)
    data, cols, offsets, x = csr_kernel_case(rng, torch.float64,
                                             torch.int32, torch.int64, CPU,
                                             tail=False, cols=6000)
    x = x.nan_to_num(nan=0.0, posinf=1.0)
    if dtype == torch.int64:
        data, x = (data * 8).round(), (x * 8).round()
    data, x = data.to(dtype), x.to(dtype)
    rows = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    rid = torch.repeat_interleave(torch.arange(rows), lengths)
    before = csr_kernel.csr_spmv.launches
    y = spmv_ops.csr_spmv_rowids(data, cols, rid, x, rows, lengths=lengths,
                                 offsets=offsets)
    assert torch.equal(y, spmv_ops.csr_spmv_rowids_plain(
        data, cols, rid, x, rows, lengths=lengths))
    X = torch.stack([x, -x], 1)
    Y = spmv_ops.csr_spmm_rowids(data, cols, rid, X, rows, lengths=lengths,
                                 offsets=offsets)
    assert torch.equal(Y[:, 0], y)
    assert csr_kernel.csr_spmv.launches == before


def test_csr_rung_builds_row_ids_only_for_integers():
    """``spmv.csr_spmv`` hands the plain ops row ids only where they
    read them (integer products): the float result is unchanged."""
    rng = np.random.default_rng(5)
    data, cols, offsets, x = csr_kernel_case(rng, torch.float32,
                                             torch.int32, torch.int64, CPU,
                                             tail=False, cols=6000)
    rows = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    rid = torch.repeat_interleave(torch.arange(rows), lengths)
    assert not spmv_ops.reads_row_ids(data, x)
    assert not spmv_ops.reads_row_ids(data.to(torch.complex64), x)
    assert spmv_ops.reads_row_ids(cols, cols)
    assert spmv_ops._plain_row_ids(data, offsets, x) is None
    assert torch.equal(spmv_ops._plain_row_ids(cols, offsets, cols),
                       rid)
    assert_bitwise(spmv_ops.csr_spmv(data, cols, offsets, x, rows),
                   spmv_ops.csr_spmv_rowids_plain(data, cols, rid, x, rows,
                                                  lengths=lengths))


def test_declining_probes_leave_no_row_ids():
    """An irregular float matrix whose DIA probe declines settles on
    csr-rowids holding no row ids (built on demand afterwards); a
    banded one keeps those its probe built."""
    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch.ops.convert import row_ids_from_indptr

    rng = np.random.default_rng(9)
    n = 3000
    data, cols, offsets, _ = csr_kernel_case(rng, torch.float32,
                                             torch.int32, torch.int64, CPU,
                                             tail=False, cols=n)
    rows = offsets.shape[0] - 1
    A = sparse.csr_array((data, cols, offsets), shape=(rows, n),
                         device=CPU)
    x = torch.from_numpy(rng.standard_normal(n)).float()
    y = A @ x
    assert A.spmv_path == "csr-rowids" and A._dia is False
    assert A._row_ids is None
    assert torch.equal(y, spmv_ops.csr_spmv_rowids_plain(
        data, cols, None, x, rows, lengths=offsets[1:] - offsets[:-1]))
    B = sparse.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(50, 50),
                     format="csr", dtype=torch.float32, device=CPU)
    B @ torch.ones(50)
    assert B._dia is not False and B._row_ids is not None
    assert torch.equal(A._get_row_ids(),
                       row_ids_from_indptr(offsets, len(data)))


def test_build_sources_list_csr_spmv():
    assert _build.SOURCES["csr_spmv"] == "csr_spmv.cu"
    assert (_build.CSRC / "csr_spmv.cu").is_file()


def test_source_constants_match_wrapper():
    """The wrapper's schedule uses the source's block, tile, chunk and
    tile-row sizes, and the device kernel's name is the one the
    benchmark's traces show."""
    text = (_build.CSRC / "csr_spmv.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"#define (\w+) (\d+)", text)}
    assert consts == {"BLOCK": csr_kernel.BLOCK, "TILE": csr_kernel.TILE,
                      "CHUNK": csr_kernel.CHUNK,
                      "TILE_ROWS": csr_kernel.TILE_ROWS}
    assert "csr_spmv_kernel(" in text and "dia_spmv" not in text


def _bad_cases():
    rng = np.random.default_rng(6)
    data, cols, offsets, x = csr_kernel_case(rng, torch.float32,
                                             torch.int32, torch.int64, CPU,
                                             tail=False, cols=6000)
    return {
        "data-strided": (ValueError, (torch.stack([data, data], 1)[:, 0],
                                      cols, offsets, x)),
        "x-strided": (ValueError, (data, cols, offsets,
                                   torch.stack([x, x], 1)[:, 0])),
        "data-2d": (ValueError, (data[:, None], cols, offsets, x)),
        "cols-length": (ValueError, (data, cols[:-1], offsets, x)),
        "no-offsets": (ValueError, (data, cols, offsets[:0], x)),
        "x-2d": (ValueError, (data, cols, offsets, x[:, None])),
        "x-dtype": (TypeError, (data, cols, offsets, x.double())),
        "complex": (TypeError, (data.to(torch.complex64), cols, offsets,
                                x.to(torch.complex64))),
        "cols-int16": (TypeError, (data, cols.short(), offsets, x)),
        "offsets-float": (TypeError, (data, cols, offsets.float(), x)),
        "device": (ValueError, (data, cols, offsets, x.to("meta"))),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_wrapper_rejects_bad_inputs(case):
    """The wrapper's checks raise without a card, before any launch."""
    exc, args = _bad_cases()[case]
    before = csr_kernel.csr_spmv.launches
    with pytest.raises(exc):
        csr_kernel.csr_spmv(*args)
    assert csr_kernel.csr_spmv.launches == before


def test_route_keeps_other_operands_off_the_kernel():
    """``supported`` takes 1-D f32/f64 values with x of their type and
    int32 or int64 columns on one device, and nothing else."""
    d = torch.zeros(4)
    c = torch.zeros(4, dtype=torch.int32)
    x = torch.zeros(3)
    assert csr_kernel.supported(d, c, x)
    assert csr_kernel.supported(d.double(), c.long(), x.double())
    assert not csr_kernel.supported(d, c, x.double())
    assert not csr_kernel.supported(d.bfloat16(), c, x.bfloat16())
    assert not csr_kernel.supported(d.to(torch.complex64), c,
                                    x.to(torch.complex64))
    assert not csr_kernel.supported(d.long(), c, x.long())
    assert not csr_kernel.supported(d, c.short(), x)
    assert not csr_kernel.supported(d, c, torch.zeros((3, 2)))
    assert not csr_kernel.supported(d, c, x.to("meta"))
    assert not spmv_ops.csr_kernel_takes(d, c, x)
