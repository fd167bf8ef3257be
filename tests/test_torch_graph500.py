# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The Graph500 Kronecker graph through the port's irregular path, on
the CPU: the generator, the assembled CSR against scipy, ``A @ x``
against the float64 reference on the ``csr-rowids`` route in both of
its summation orders, and the probe and kernel spans and counters."""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import obs, runtime
from legate_sparse_tpu_torch.obs import counters, trace
from legate_sparse_tpu_torch.ops import spmv as spmv_ops

from utils_test import graph500_ref as g500

SEED = 26


@pytest.fixture(autouse=True)
def _isolation():
    runtime.set_device("cpu")
    obs.reset_all()
    trace.disable()
    yield
    trace.disable()
    obs.reset_all()
    runtime.set_device(None)


_GRAPHS = {}


def graph(scale):
    """The port's ``csr_array`` of the graph at ``scale`` (float32, as
    the benchmark's configuration) and its float64 arrays."""
    if scale not in _GRAPHS:
        data, indices, indptr = g500.assemble(scale, SEED)
        _GRAPHS[scale] = (data, indices, indptr)
    data, indices, indptr = _GRAPHS[scale]
    n = 1 << scale
    A = tsparse.csr_array((data.to(torch.float32), indices, indptr),
                          shape=(n, n))
    return A, (data, indices, indptr)


def test_generator_counts_quadrants_and_permutation():
    scale = 14
    i, j, w = g500.quadrant_bits(scale, SEED)
    m = 16 << scale
    assert i.shape[0] == j.shape[0] == w.shape[0] == m
    assert int(i.max()) < 1 << scale and int(j.max()) < 1 << scale
    assert 0.0 <= float(w.min()) and float(w.max()) < 1.0
    quadrant = (i & 1) * 2 + (j & 1)
    for q, p in enumerate(g500.INITIATOR):
        seen = int((quadrant == q).sum()) / m
        assert abs(seen - p) <= 4 * math.sqrt(p * (1 - p) / m), (q, seen)
    perm = g500.permutation(scale, SEED)
    assert torch.equal(torch.sort(perm).values, torch.arange(1 << scale))
    pi, pj, _ = g500.edge_list(scale, SEED)
    assert pi.shape[0] == m and torch.equal(pi, perm[i])


def test_assembled_csr_is_scipys_undirected_graph():
    scale = 10
    data, indices, indptr = g500.assemble(scale, SEED)
    n = 1 << scale
    got = sp.csr_matrix((data.numpy(), indices.numpy(), indptr.numpy()),
                        shape=(n, n))
    assert got.has_canonical_format
    assert got.diagonal().max() == 0 and (got != got.T).nnz == 0
    i, j, w = (t.numpy() for t in g500.edge_list(scale, SEED))
    keep = i != j
    i, j, w = i[keep], j[keep], w[keep].astype(np.float64)
    want = sp.coo_matrix((np.concatenate([w, w]),
                          (np.concatenate([i, j]), np.concatenate([j, i]))),
                         shape=(n, n)).tocsr()
    want.sum_duplicates()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-15)


@pytest.mark.parametrize("scale", [8, 12, 16])
def test_product_equals_the_reference(scale):
    """float32 values and x against the float64 scatter of the edge
    list: each row within (its length + 3) float32 roundings of
    ``(|A| @ |x|)_i`` (the values' own rounding, the products' and the
    sum's in any order)."""
    A, (data, indices, indptr) = graph(scale)
    n = 1 << scale
    x = torch.rand(n, generator=torch.Generator().manual_seed(scale)) * 2 - 1
    y = A @ x
    assert A.spmv_path == "csr-rowids"
    want = g500.apply(scale, SEED, x)
    absA = sp.csr_matrix((data.abs().numpy(), indices.numpy(),
                          indptr.numpy()), shape=(n, n))
    lengths = np.diff(indptr.numpy())
    bound = (lengths + 3) * np.finfo(np.float32).eps * (
        absA @ np.abs(x.numpy().astype(np.float64)))
    gap = np.abs(y.numpy().astype(np.float64) - want.numpy())
    assert (gap <= bound).all(), float((gap - bound).max())
    longest = int(lengths.max())
    assert A._serial_rows() == (longest <= spmv_ops.SERIAL_MAX_ROW)
    if scale == 16:
        assert longest > spmv_ops.SERIAL_MAX_ROW and not A._serial_rows()
        assert A._get_dia() is None and A._get_ell() is None
        assert A._get_bsr() is None
    if scale == 8:
        assert A._serial_rows()


def test_probe_and_kernel_spans_and_counters():
    A, _ = graph(12)
    x = torch.ones(A.shape[0])
    trace.enable()
    A @ x
    A @ x
    recs = obs.records()
    kernels = [r for r in recs if r["name"] == "kernel.csr_rowids"]
    assert len(kernels) == 2
    assert kernels[0]["attrs"] == {"rows": A.shape[0], "entries": A.nnz,
                                   "serial": A._serial_rows()}
    probes = {r["attrs"]["format"]: r["attrs"] for r in recs
              if r["name"] == "dispatch.probe"}
    assert len([r for r in recs if r["name"] == "dispatch.probe"]) == 3
    assert all(p["declined"] for p in probes.values())
    assert probes["dia"]["diagonals"] > 62
    assert probes["ell"]["width"] == A._get_ell_width()
    assert counters.snapshot("dispatch.declined.") == {
        "dispatch.declined.dia": 1, "dispatch.declined.bsr": 1,
        "dispatch.declined.ell": 1}
    spmv = [r for r in recs if r["name"] == "spmv"]
    assert [s["attrs"]["path"] for s in spmv] == ["csr-rowids"] * 2
    assert kernels[0]["depth"] > spmv[0]["depth"]


def test_probes_count_declines_with_tracing_off():
    A, _ = graph(8)
    A @ torch.ones(A.shape[0])
    assert obs.records() == []
    assert counters.snapshot("dispatch.declined.") == {
        "dispatch.declined.dia": 1, "dispatch.declined.bsr": 1,
        "dispatch.declined.ell": 1}


def test_banded_matrix_probe_accepts_once():
    S = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(64, 64), format="csr",
                 dtype=np.float32)
    A = tsparse.csr_array(S)
    trace.enable()
    A @ torch.ones(64)
    A @ torch.ones(64)
    (probe,) = [r for r in obs.records() if r["name"] == "dispatch.probe"]
    assert probe["attrs"] == {"format": "dia", "diagonals": 3,
                              "declined": False}
    assert counters.snapshot("dispatch.declined.") == {}
