"""The ``kronecker`` family and the ``rmat-s25.matvec`` cell at a test
size: the cell on the CPU at SCALE 12 (correct; the bfloat16 control
and two planted faults of the assembly not), the least bytes against
their closed form, and the reference against scipy.  One ``gpu`` case
runs the cell at SCALE 20 through the card.

    python -m pytest -p no:cacheprovider spbench/tests/test_spbench_kronecker.py
"""

import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spbench.core import harness, spec, work
from spbench.core import traffic as _traffic
from spbench.operators import kronecker as family
from spbench.reference import kronecker as graph

WORKLOAD = "rmat-s25.matvec"
SEEDS = (2 ** 31 + 3, 2 ** 31 + 29, 3_000_000_019)


def cell_at(scale):
    """The cell with the graph cut to ``scale``; its stored-entry count
    is then counted from the edge list."""
    c = spec.cell(WORKLOAD)
    c.config = {k: v for k, v in c.config.items() if k != "nnz"}
    c.config["scale"] = scale
    return c


def run(cell, seed=SEEDS[0], device=torch.device("cpu"), trace=False,
        seconds=0.3):
    return harness.run(WORKLOAD, seed, seconds, trace, device,
                       time.perf_counter(), cell=cell)


def test_configuration_and_cell():
    c = spec.cell(WORKLOAD)
    assert c.config["operator"] == "kronecker" and c.chips == 1
    assert c.config["scale"] == 25 and c.config["edge_factor"] == 16
    assert c.config["initiator"] == [0.57, 0.19, 0.19, 0.05]
    assert c.config["reduced"] == ["scale"]
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "matvec_ms"}
    assert "csr_spmv_roofline.matvec" in {m["name"] for m in c.per_layer}


def test_cell_runs_correct_on_cpu():
    r = run(cell_at(12))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "matvec_ms"}


def test_control_reads_above_the_limit():
    cell = cell_at(12)
    dev = torch.device("cpu")
    A, M, mix, _ = harness.build(cell, dev, SEEDS[0], False,
                                 time.perf_counter())
    kind = spec.part("kinds", cell.traffic["kind"])
    limit = cell.limits["checks"]["max_rel_err"]["limit"]
    for seed in SEEDS:
        mix = kind.Mix(cell.traffic, cell.config, mix.n, dev, torch.float32,
                       seed)
        mix.prepare(A, M)
        window = mix.run(A, M, 0.2, False)
        program = harness.compare(cell, mix, window)["max_rel_err"]
        control = harness.compare(cell, mix, window, True)["max_rel_err"]
        p = _traffic.worst(program.values())
        c = _traffic.worst(control.values())
        assert p <= limit < c, (seed, p, limit, c)


def _hub_entry_dropped(data, indices, indptr):
    """One entry of the longest row left out."""
    row = int(torch.argmax(indptr[1:] - indptr[:-1]))
    at = int(indptr[row])
    keep = torch.ones(data.shape[0], dtype=torch.bool)
    keep[at] = False
    indptr = indptr.clone()
    indptr[row + 1:] -= 1
    return data[keep], indices[keep], indptr


def _duplicate_unsummed(config):
    """One entry that several generated edges share holding the first
    edge's weight alone."""
    def plant(data, indices, indptr):
        op = graph.Operator(config, "cpu")
        i, j, w = (torch.cat(t) for t in zip(*op.edges()))
        key = i * op.n + j
        uniq, counts = torch.unique(key, return_counts=True)
        dup = int(uniq[counts > 1][0])
        r, c = divmod(dup, op.n)
        first = float(w[key == dup][0])
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        at = lo + int(torch.nonzero(indices[lo:hi] == c)[0])
        data = data.clone()
        assert float(data[at]) != first
        data[at] = first
        return data, indices, indptr
    return plant


@pytest.mark.parametrize("fault", ["hub_entry_dropped",
                                   "duplicate_unsummed"])
def test_planted_assembly_fault_is_not_correct(fault, monkeypatch):
    cell = cell_at(12)
    plant = (_hub_entry_dropped if fault == "hub_entry_dropped"
             else _duplicate_unsummed(cell.config))
    assemble = family.assemble

    def broken(config, dtype, device, seed):
        return plant(*assemble(config, dtype, device, seed))

    monkeypatch.setattr(family, "assemble", broken)
    r = run(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_spmv_bytes_equal_the_closed_form():
    cfg = spec.config("rmat-s25")
    n, nnz = 1 << 25, cfg["nnz"]
    assert family.rows(cfg) == n and family.nnz(cfg) == nnz
    assert family.spmv_bytes(cfg) == nnz * 8 + (n + 1) * 4 + 2 * n * 4
    assert 8.5e9 < family.spmv_bytes(cfg) < 9.0e9
    small = dict(cfg, scale=10)
    del small["nnz"]
    d, i, p = family.assemble(small, torch.float32, "cpu", 0)
    assert family.nnz(small) == d.shape[0] == i.shape[0] == int(p[-1])
    assert work.spmv_flops(cfg) == 2 * nnz


def _scipy_graph(config):
    i, j, w = (t.numpy() for t in graph.chunk(
        config, 0, graph.permutation(config, "cpu")))
    keep = i != j
    i, j, w = i[keep], j[keep], w[keep].astype(np.float64)
    n = graph.vertices(config)
    return sp.coo_matrix((np.concatenate([w, w]),
                          (np.concatenate([i, j]), np.concatenate([j, i]))),
                         shape=(n, n)).tocsr()


def test_reference_and_assembly_equal_scipy():
    cfg = dict(cell_at(10).config)
    A = _scipy_graph(cfg)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, A.shape[0]))
    ref = graph.operator(cfg, 0, "cpu")
    np.testing.assert_allclose(ref.apply(x).numpy(), A @ x.numpy(),
                               rtol=1e-13, atol=1e-13)
    X = torch.stack([x, 2 * x], 1)
    np.testing.assert_allclose(ref.apply(X).numpy(), A @ X.numpy(),
                               rtol=1e-13, atol=1e-13)
    M = ref.matrix()
    got = sp.csr_matrix((M.values().numpy(), M.col_indices().numpy(),
                         M.crow_indices().numpy()), shape=A.shape)
    assert abs(got - A).max() < 1e-15
    d, i, p = family.assemble(cfg, torch.float64, "cpu", 0)
    fam = sp.csr_matrix((d.numpy(), i.numpy(), p.numpy()), shape=A.shape)
    assert fam.has_canonical_format and fam.diagonal().max() == 0
    np.testing.assert_array_equal(fam.indptr, A.indptr)
    np.testing.assert_array_equal(fam.indices, A.indices)
    np.testing.assert_allclose(fam.data, A.data, rtol=1e-15)
    assert family.nnz(cfg) == graph.stored_entries(cfg) == A.nnz


@pytest.mark.gpu
def test_cell_at_scale_20_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    cuda = torch.device("cuda", 0)
    cell = cell_at(20)
    d, i, p = family.assemble(cell.config, torch.float32, cuda, 0)
    cell.config["nnz"] = int(d.shape[0])
    del d, i, p
    plain = run(cell, device=cuda, seconds=1.0)
    assert plain["correct"], plain["checks"]
    traced = run(cell, SEEDS[1], device=cuda, trace=True, seconds=2.0)
    assert traced["correct"], traced["checks"]
    metrics = traced["metrics"]
    assert {m["name"] for m in cell.per_layer} == set(metrics)
    assert 0 < metrics["csr_spmv_roofline.matvec"]["value"] <= 100
