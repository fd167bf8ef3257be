# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The ELL SpMV kernel's route, build entry and checks on the CPU.

``ops/spmv.py::ell_spmv`` sends CPU operands to ``ell_spmv_plain``, the
ops the JAX-parity tests hold, bit for bit and with no launch; only
CUDA operands of the kernel's types reach ``ops/ell_kernel.py``.  The
kernel itself runs on the card (``tests/test_torch_gpu.py``, whose
cases this file shares).  This file imports no JAX.
"""

import re

import numpy as np
import pytest
import torch

from legate_sparse_tpu_torch.ops import _build, ell_kernel
from legate_sparse_tpu_torch.ops import spmv as spmv_ops

from test_torch_gpu import (ELL_KERNEL_WIDTHS, ELL_WIDE_W, assert_bitwise,
                            ell_case)

CPU = torch.device("cpu")


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64])
@pytest.mark.parametrize("W", ELL_KERNEL_WIDTHS + (ELL_WIDE_W,))
def test_cpu_route_is_plain_bit_for_bit(W, dtype, index_dtype):
    rng = np.random.default_rng(200 + W)
    data, cols, counts, x = ell_case(300, 400, W, rng, torch.float64,
                                     index_dtype, CPU)
    if dtype.is_complex:
        # A complex product with an infinite factor reads NaN.
        x = x.nan_to_num(nan=0.0, posinf=1.0, neginf=-1.0)
    data, x = data.to(dtype), x.to(dtype)
    before = ell_kernel.ell_spmv.launches
    y = spmv_ops.ell_spmv(data, cols, counts, x)
    assert ell_kernel.ell_spmv.launches == before
    assert y.dtype == dtype
    assert torch.equal(y, spmv_ops.ell_spmv_plain(data, cols, counts, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("W", ELL_KERNEL_WIDTHS)
def test_slot_order_twin_against_plain(W, dtype):
    """The kernel's plain twin (what the wrapper runs on CPU operands)
    keeps the NaN of x at padded slots out of y, reads +0.0 in empty
    rows, and is within 1e-5 (f32) or 1e-12 (f64) of the plain ops,
    whose ``sum`` takes another order."""
    rng = np.random.default_rng(300 + W)
    data, cols, counts, x = ell_case(300, 400, W, rng, dtype, torch.int32,
                                     CPU)
    y = ell_kernel.ell_spmv(data, cols, counts, x)
    assert_bitwise(y, ell_kernel.ell_spmv_ordered(data, cols, counts, x))
    assert not y.isnan().any()
    assert torch.equal(y[counts == 0], torch.zeros_like(y[counts == 0]))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(
        y, spmv_ops.ell_spmv_plain(data, cols, counts, x), rtol=tol,
        atol=tol, equal_nan=True)


def test_gmg_transfer_operators_route_plain_on_cpu():
    """The V-cycle's R and P on the CPU: "ell", the plain ops bit for
    bit, no launch."""
    from legate_sparse_tpu_torch.apps.gmg import linear_operator
    R, _ = linear_operator(32 * 32, dtype=torch.float32, device=CPU)
    P = R.T
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        32 * 32).astype(np.float32))
    before = ell_kernel.ell_spmv.launches
    r = R.dot(x)
    p = P.dot(r)
    assert ell_kernel.ell_spmv.launches == before
    assert R.spmv_path == P.spmv_path == "ell"
    assert torch.equal(r, spmv_ops.ell_spmv_plain(*R._get_ell(), x))
    assert torch.equal(p, spmv_ops.ell_spmv_plain(*P._get_ell(), r))


def test_build_sources_list_ell_spmv():
    assert _build.SOURCES["ell_spmv"] == "ell_spmv.cu"
    assert (_build.CSRC / "ell_spmv.cu").is_file()


def test_source_constants_match_wrapper():
    """The wrapper's widest pack is the source's: the kernel is compiled
    for every width from 1 to MAX_TILE_W and refuses a wider one."""
    text = (_build.CSRC / "ell_spmv.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"#define (\w+) (\d+)", text)}
    assert consts["MAX_TILE_W"] == ell_kernel.MAX_TILE_W
    assert all(f"ELL_W({w})" in text
               for w in range(1, ell_kernel.MAX_TILE_W + 1))
    assert f"ELL_W({ell_kernel.MAX_TILE_W + 1})" not in text
    assert "W > MAX_TILE_W" in text


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_pack_is_outside_the_kernel(dtype):
    """A pack wider than ``MAX_TILE_W`` is not the kernel's: ``supported``
    says no, so ``spmv.ell_spmv`` takes the plain ops wherever the
    operands live, and the wrapper itself refuses it."""
    rng = np.random.default_rng(8)
    data, cols, counts, x = ell_case(200, 300, ELL_WIDE_W, rng, dtype,
                                     torch.int32, CPU)
    assert not ell_kernel.supported(data, cols, counts, x)
    assert ell_kernel.supported(data[:, :ell_kernel.MAX_TILE_W].contiguous(),
                                cols[:, :ell_kernel.MAX_TILE_W].contiguous(),
                                counts, x)
    before = ell_kernel.ell_spmv.launches
    assert torch.equal(spmv_ops.ell_spmv(data, cols, counts, x),
                       spmv_ops.ell_spmv_plain(data, cols, counts, x))
    with pytest.raises(ValueError, match="slots a row"):
        ell_kernel.ell_spmv(data, cols, counts, x)
    assert ell_kernel.ell_spmv.launches == before


def _bad_cases():
    rng = np.random.default_rng(6)
    data, cols, counts, x = ell_case(50, 60, 4, rng, torch.float32,
                                     torch.int32, CPU)
    return {
        "data-strided": (ValueError, (data.t().contiguous().t(), cols,
                                      counts, x)),
        "x-strided": (ValueError, (data, cols, counts,
                                   torch.stack([x, x], 1)[:, 0])),
        "data-1d": (ValueError, (data[:, 0], cols, counts, x)),
        "cols-shape": (ValueError, (data, cols[:-1], counts, x)),
        "counts-shape": (ValueError, (data, cols, counts[:-1], x)),
        "x-2d": (ValueError, (data, cols, counts, x[:, None])),
        "no-slots": (ValueError, (data[:, :0], cols[:, :0], counts, x)),
        "too-wide": (ValueError, tuple(ell_case(
            50, 60, ELL_WIDE_W, rng, torch.float32, torch.int32, CPU))),
        "x-dtype": (TypeError, (data, cols, counts, x.double())),
        "complex": (TypeError, (data.to(torch.complex64), cols, counts,
                                x.to(torch.complex64))),
        "cols-int16": (TypeError, (data, cols.short(), counts, x)),
        "counts-int64": (TypeError, (data, cols, counts.long(), x)),
        "device": (ValueError, (data, cols, counts, x.to("meta"))),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_wrapper_rejects_bad_inputs(case):
    """The wrapper's checks raise without a card, before any launch."""
    exc, args = _bad_cases()[case]
    before = ell_kernel.ell_spmv.launches
    with pytest.raises(exc):
        ell_kernel.ell_spmv(*args)
    assert ell_kernel.ell_spmv.launches == before


def test_route_keeps_other_operands_off_the_kernel():
    """``supported`` takes f32/f64 values with x of their type, int32 or
    int64 columns and int32 counts, and nothing else."""
    d = torch.zeros((4, 2))
    c = torch.zeros((4, 2), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    x = torch.zeros(3)
    assert ell_kernel.supported(d, c, n, x)
    assert ell_kernel.supported(d.double(), c.long(), n, x.double())
    assert not ell_kernel.supported(d, c, n, x.double())
    assert not ell_kernel.supported(d.bfloat16(), c, n, x.bfloat16())
    assert not ell_kernel.supported(d.to(torch.complex64), c, n,
                                    x.to(torch.complex64))
    assert not ell_kernel.supported(d, c.short(), n, x)
    assert not ell_kernel.supported(d, c, n.long(), x)
    assert not ell_kernel.supported(d, c, n, torch.zeros((3, 2)))
