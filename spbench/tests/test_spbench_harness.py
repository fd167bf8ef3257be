"""The harness on the CPU: names, work counts, inputs, reference, runs.

Run from the root of the checkout::

    python -m pytest -p no:cacheprovider spbench/tests
"""

import ast
import json
import math
import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

from spbench.core import harness, profile, spec, work
from spbench.kinds import solve as solve_kind
from spbench.operators import stencil as family
from spbench.reference import cg as ref_cg
from spbench.reference import gmg as ref_gmg
from spbench.reference import stencil

SPBENCH = Path(spec.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "legate_sparse_tpu"}


def tiny(workload, grid, levels=None):
    """The cell with its grid cut to a test size (and the GMG's levels
    to fit it)."""
    c = spec.cell(workload)
    c.config = dict(c.config, grid=list(grid))
    if levels is not None:
        c.traffic = dict(c.traffic, preconditioner=dict(
            c.traffic["preconditioner"], levels=levels))
    return c


TINY = {"poisson2d-8192.gmg": ([64, 64], 3),
        "hpcg-256.cg": ([8, 9, 10], None),
        "hpcg-256.matvec": ([6, 7, 8], None),
        "poisson2d-4096.matvec": ([32, 48], None)}


def tiny_cell(workload):
    grid, levels = TINY[workload]
    return tiny(workload, grid, levels)


def run_tiny(workload, seed=2 ** 31 + 11, seconds=0.3, trace=False):
    return harness.run(workload, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), cell=tiny_cell(workload))


# ---------------- BENCHMARK.json and the files it names ----------------

def test_every_part_found_by_name():
    bench = spec.benchmark()
    assert set(TINY) == {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c.config["name"] == w["config"]
        for folder in ("operators", "reference"):
            assert spec.part(folder, c.config["operator"])
        assert spec.part("kinds", c.traffic["kind"]).Mix
        if c.traffic["kind"] == "solve":
            assert spec.part("reference", c.traffic["solver"]["name"]).crossing
        pre = c.traffic.get("preconditioner")
        if pre:
            assert spec.part("preconditioners", pre["name"]).build
            assert spec.part("reference", pre["name"]).Preconditioner
        assert c.limits["checks"]["max_rel_err"]["limit"] > 0
        for name, check in c.limits["checks"].items():
            assert isinstance(check["limit"], (int, float)), (w, name)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_names_and_units():
    bench = spec.benchmark()
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith("spbench/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers <= {"entry and structures", "solver", "preconditioner",
                      "dispatch", "kernel", "device"}


def test_imports_no_jax_and_reference_nothing_of_the_program():
    for path in SPBENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops.add(node.module.split(".")[0])
        assert not tops & JAX, (path, tops & JAX)
        if "reference" in path.parts:
            assert tops <= {"__future__", "math", "typing", "numpy",
                            "torch"}, path


# ---------------- the yardstick ----------------

def test_work_counts_equal_the_closed_forms():
    p = spec.config("poisson2d-4096")
    h = spec.config("hpcg-256")
    assert work.operator_nnz(p) == 5 * 4096 ** 2 - 4 * 4096 == 83_869_696
    assert work.operator_nnz(h) == (3 * 256 - 2) ** 3 == 449_455_096
    assert work.spmv_bytes(p) == 83_869_696 * 4 + 2 * 4096 ** 2 * 4
    assert work.spmv_bytes(h) == 449_455_096 * 4 + 2 * 256 ** 3 * 4
    assert round(work.spmv_bytes(p) / 1e6, 1) == 469.7
    assert round(work.spmv_bytes(h) / 1e9, 3) == 1.932
    assert math.isclose(work.spmv_min_seconds(p) * 1e3, 0.1402, abs_tol=5e-5)
    assert math.isclose(work.spmv_min_seconds(h) * 1e3, 0.5767, abs_tol=5e-5)
    g = spec.config("poisson2d-8192")
    assert work.operator_nnz(g) == 5 * 8192 ** 2 - 4 * 8192 == 335_511_552
    assert work.spmv_bytes(g) == 335_511_552 * 4 + 2 * 8192 ** 2 * 4


def scipy_operator(grid, st):
    """The operator by Kronecker products, built apart from the
    harness: star = sum of 1-D second differences, box = a shifted
    product of 1-D (1, 1, 1) bands."""
    c, v = st["center"], st["neighbor"]
    eye = [sp.identity(g, format="csr") for g in grid]
    if st["shape"] == "star":
        A = sp.csr_matrix((math.prod(grid),) * 2)
        for a, g in enumerate(grid):
            band = sp.diags([np.ones(g - 1), np.ones(g - 1)], [-1, 1]) * v
            term = None
            for b, e in enumerate(eye):
                f = band if a == b else e
                term = f if term is None else sp.kron(term, f)
            A = A + term
        return (A + c * sp.identity(math.prod(grid))).tocsr()
    T = None
    for g in grid:
        t = sp.diags([np.ones(g - 1), np.ones(g), np.ones(g - 1)],
                     [-1, 0, 1])
        T = t if T is None else sp.kron(T, t)
    return ((c - v) * sp.identity(math.prod(grid)) + v * T).tocsr()


CASES = [([5, 7], {"shape": "star", "center": 4.0, "neighbor": -1.0}),
         ([3, 4, 5], {"shape": "box", "center": 26.0, "neighbor": -1.0}),
         ([2, 6, 3], {"shape": "star", "center": 6.0, "neighbor": -1.0})]


@pytest.mark.parametrize("grid,st", CASES)
def test_assembly_equals_scipy(grid, st):
    data, indices, indptr = family.assemble({"grid": grid, "stencil": st},
                                            torch.float64, "cpu", 0)
    want = scipy_operator(grid, st)
    want.eliminate_zeros()
    want.sort_indices()
    got = sp.csr_matrix((data.numpy(), indices.numpy(), indptr.numpy()),
                        shape=want.shape)
    assert got.has_sorted_indices
    assert (got != want).nnz == 0
    assert got.nnz == want.nnz == stencil.nnz(grid, st)


@pytest.mark.parametrize("grid,st", CASES)
def test_reference_equals_scipy(grid, st):
    A = scipy_operator(grid, st)
    x = torch.from_numpy(np.random.default_rng(3).random(A.shape[0]))
    np.testing.assert_allclose(stencil.apply(grid, st, x).numpy(),
                               A @ x.numpy(), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(stencil.solve(grid, st, x).numpy(),
                               sla.spsolve(A.tocsc(), x.numpy()),
                               rtol=1e-10, atol=1e-12)
    M = stencil.matrix(grid, st)
    got = sp.csr_matrix((M.values().numpy(), M.col_indices().numpy(),
                         M.crow_indices().numpy()), shape=A.shape)
    assert abs(got - A).max() == 0


def test_reference_cg_crossing_against_a_plain_loop():
    """The crossing is where scipy's residual test first holds."""
    grid, st = CASES[1]
    A = scipy_operator(grid, st)
    b = np.random.default_rng(5).random(A.shape[0])
    for rtol in (1e-3, 1e-6):
        k = ref_cg.crossing(lambda v: stencil.apply(grid, st, v), None,
                            torch.from_numpy(b), rtol, 500)
        seen = []
        sla.cg(A, b, rtol=rtol, atol=0.0, maxiter=500,
               callback=lambda xk: seen.append(xk))
        assert k == len(seen), (rtol, k, len(seen))


def test_reference_vcycle_equals_the_programs_in_float64():
    """A witness at a test size: the reference V-cycle, rebuilt from
    its definition, and the program's ``apps/gmg.py`` agree in float64."""
    from legate_sparse_tpu_torch.apps.gmg import GMG

    cfg = dict(spec.config("poisson2d-4096"), grid=[32, 32])
    params = dict(spec.traffic("gmg")["preconditioner"], levels=3)
    data, indices, indptr = family.assemble(cfg, torch.float64, "cpu", 0)
    from spbench.core import system
    A = system.operator(data, indices, indptr, (1024, 1024))
    mg = GMG(A, (32, 32), 3, "jacobi", "linear", 1)
    ref = ref_gmg.Preconditioner(stencil.operator(cfg, 0, "cpu"), cfg,
                                 params)
    r = torch.from_numpy(np.random.default_rng(9).random(1024))
    want = ref.apply(r)
    assert harness._traffic.rel_err(mg.cycle(r), want) < 1e-12
    assert harness._traffic.rel_err(ref.apply(r, torch.bfloat16),
                                    want) > 1e-4


# ---------------- runs at a test size ----------------

@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_runs_correct_on_cpu(workload):
    r = run_tiny(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    cell = spec.cell(workload)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
    for m in r["metrics"].values():
        assert m["value"] > 0


def test_traced_run_on_cpu_reports_no_device_metric():
    r = run_tiny("poisson2d-8192.gmg", trace=True)
    assert r["correct"]
    assert set(r["metrics"]) == {"setup.operator_s", "gmg.hierarchy_s",
                                 "gmg.cg_iters"}
    assert "busy_s" not in r["device"]


def test_same_seed_same_inputs():
    a = harness.spec.cell("hpcg-256.cg")
    cfg = dict(a.config, grid=[4, 4, 4])
    t1 = solve_kind.Mix(a.traffic, cfg, 64, "cpu", torch.float32,
                        2 ** 31 + 5)
    t2 = solve_kind.Mix(a.traffic, cfg, 64, "cpu", torch.float32,
                        2 ** 31 + 5)
    assert torch.equal(t1.rhs(3), t2.rhs(3))
    assert not torch.equal(t1.rhs(3), t1.rhs(4))
    assert 0.0 <= float(t1.rhs(0).min()) and float(t1.rhs(0).max()) < 1.0


# ---------------- the trace reduction ----------------

def _ev(name, start, end, cuda=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=False)


def test_trace_reduction_busy_idle_and_launches():
    events = [
        _ev("cudaLaunchKernel", 100.0, 104.0),
        _ev("cudaMemcpyAsync", 150.0, 170.0),
        _ev("void dia_spmv_kernel<5>", 105.0, 125.0, cuda=True),
        _ev("void dia_spmv_kernel<5>", 120.0, 140.0, cuda=True),
        _ev("Memcpy DtoH", 165.0, 166.0, cuda=True),
        _ev("elementwise", 190.0, 210.0, cuda=True),
    ]
    t = profile.reduce_events(events, 150e-6)
    assert t.window_s == 150e-6
    assert math.isclose(t.busy_s, (35 + 1 + 20) * 1e-6)
    assert t.launches == 3
    assert t.matching("dia_spmv") == (2, pytest.approx(40e-6))
    assert t.idle == {"cudaMemcpyAsync": pytest.approx(25e-6),
                      profile.BETWEEN: pytest.approx(24e-6),
                      profile.EDGES: pytest.approx(45e-6)}
    assert math.isclose(sum(t.idle.values()), t.window_s - t.busy_s)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "void dia_spmv_kernel<5>"
    assert len(bd["idle_gaps"]) <= 10
