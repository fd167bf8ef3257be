# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's entry-point apps against ``examples/`` driven by the JAX
package.

The examples are driven as ``tests/test_examples.py`` drives them: their
modules imported from ``examples/`` with ``--package tpu`` (float64 on
this CPU lane).  The port runs on ``device="cpu"``.  Tolerances:

- ``apps.common``'s generators: ``data``, ``indices`` and ``indptr``
  bit for bit with ``examples/common.py``'s (N <= 256);
- the SpMV microbenchmark's product, bit for bit with the JAX
  package's ``A @ x`` (the band summed in offset order), its printed
  line parsed back;
- the SpGEMM microbenchmark's product, stable and fresh, bit for bit
  (the banded matrix, and a ``.mtx`` file written by scipy);
- the spectral pipeline at n = 400: components and labels equal,
  eigenvalues at 1e-8 against the JAX package and scipy;
- ``--explicit`` and ``--throughput`` at 1e-12 (f64) against the
  example's arithmetic run by the JAX package, iterations equal;
- ``--distributed`` at 3 gloo ranks (pde and GMG in one ``run_ranks``
  call, SpGEMM in its own): iterations equal to the single-device run,
  x within 1e-10 (f64), the distributed SpGEMM product bit for bit; the
  pde run also against ``examples/pde.py --distributed``'s solve by the
  JAX package on a 3-device CPU mesh, iterations equal, x within
  1e-10.
"""

import os
import re
import sys

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from legate_sparse_tpu_torch import interop
from legate_sparse_tpu_torch.apps import common as tcommon
from legate_sparse_tpu_torch.apps import gmg as tgmg
from legate_sparse_tpu_torch.apps import pde as tpde
from legate_sparse_tpu_torch.apps import spectral as tspectral
from legate_sparse_tpu_torch.apps import spgemm_microbenchmark as tspgemm
from legate_sparse_tpu_torch.apps import spmv_microbenchmark as tspmv

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def example():
    """``examples/common.py`` and ``examples/pde.py`` bound to the JAX
    package."""
    sys.path.insert(0, EXAMPLES)
    argv = sys.argv
    sys.argv = ["test", "--package", "tpu"]
    try:
        import common
        import pde

        common.parse_common_args()
        pde.np, pde.sparse, pde.linalg = common.np, common.sparse, \
            common.linalg
        yield common, pde
    finally:
        sys.argv = argv
        sys.path.remove(EXAMPLES)


def _same_parts(Aj, At):
    """A JAX-package matrix and a port one: shape, data (bf16 by its
    bits), indices and indptr bit for bit."""
    dt, it, pt = interop.to_numpy_parts(At)
    assert tuple(Aj.shape) == tuple(At.shape)
    dj = np.asarray(Aj.data)
    if At.dtype == torch.bfloat16:
        dt, dj = At.data.view(torch.int16).numpy(), dj.view(np.int16)
    assert dt.dtype == dj.dtype
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(it.astype(np.int64),
                                  np.asarray(Aj.indices).astype(np.int64))
    np.testing.assert_array_equal(pt.astype(np.int64),
                                  np.asarray(Aj.indptr).astype(np.int64))


STENCIL = [[0.0, -1.0, 0.0], [-1.5, 4.0, -0.5], [0.25, -1.0, 0.0]]
GENERATORS = {
    "banded_256_11": lambda c, **k: c.banded_matrix(256, 11, **k),
    "banded_64_5_diags": lambda c, **k: c.banded_matrix(64, 5, True, **k),
    "stencil_9x7": lambda c, **k: c.stencil_grid(STENCIL, (9, 7), **k),
    "poisson_16": lambda c, **k: c.poisson2D(16, **k),
    "diffusion_16": lambda c, **k: c.diffusion2D(16, **k),
    "diffusion_8_aniso": lambda c, **k: c.diffusion2D(
        8, epsilon=0.1, theta=np.pi / 4, **k),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match_example(example, name):
    common, _ = example
    gen = GENERATORS[name]
    _same_parts(gen(common), gen(tcommon, device="cpu"))


def test_harness_options():
    h = tcommon.parse_common_args(CPU + ["--dtype", "float32"])
    assert (h.package, h.device.type, h.dtype) == ("torch", "cpu",
                                                   torch.float32)
    assert isinstance(h.timer, tcommon.TorchTimer)
    assert tcommon.parse_common_args(CPU).dtype == torch.float64
    # The platform's float, as examples/common.py picks it: on cuda the
    # kernels' f32, so the default commands reach them.
    assert tcommon.harness_float("torch", "cpu") == torch.float64
    assert tcommon.harness_float("torch", "cuda") == torch.float32
    assert tcommon.harness_float("scipy", "cuda") == np.float64
    hs = tcommon.parse_common_args(["--package", "scipy"])
    assert hs.package == "scipy" and hs.dtype == np.float64
    assert isinstance(hs.timer, tcommon.NumPyTimer)
    assert [tcommon.get_arg_number(a) for a in ("", "3", "4k", "2m", "1g")
            ] == [1, 3, 4096, 2 << 20, 1 << 30]


SPMV_LINE = re.compile(r"^SPMV rows: (\d+), nnz: (\d+) , ms / iter: "
                       r"([0-9.e+-]+)$")


@pytest.mark.parametrize("argv", [[], ["--use-out"], ["--repartition"],
                                  ["-d", "--dtype", "float32"]])
def test_spmv_microbenchmark_matches_jax(example, capsys, argv):
    """The app's sweep on the CPU (two sizes with the default options):
    each line parses, each last product equals the JAX package's product
    of the same matrix."""
    common, _ = example
    sizes = [200, 400] if not argv else [200]
    recs = tspmv.main(CPU + ["--nmin", "200", "--nmax", str(sizes[-1]),
                             "-i", "3"] + argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [int(SPMV_LINE.match(ln).group(1)) for ln in lines] == sizes
    for rec, ln in zip(recs, lines):
        N = rec["rows"]
        assert int(SPMV_LINE.match(ln).group(2)) == rec["nnz"]
        assert float(SPMV_LINE.match(ln).group(3)) > 0
        Aj = common.banded_matrix(N, 11, "-d" in argv)
        # The last of the 3 timed products (even index) is A @ x, x = 1,
        # with --repartition and --use-out too.
        np.testing.assert_array_equal(rec["y"].double().numpy(),
                                      np.asarray(Aj @ np.ones(N)))
        assert rec["path"].startswith("dia")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spmv_dispatch_bitwise_random_values(example, dtype):
    """The benchmark's dispatch on a banded matrix with seeded values
    and a seeded x against the JAX package's ``A @ x``: bit for bit in
    f32 (the DIA kernel's plain version, offset order); in f64, where
    the port takes its plain shifted adds, at rtol 1e-15 (2 of 300
    entries differ by one ulp)."""
    import legate_sparse_tpu as jsparse

    rng = np.random.default_rng(3)
    base = tcommon.banded_matrix(300, 11, device="cpu")
    _, idx, ptr = interop.to_numpy_parts(base)
    vals = rng.standard_normal(idx.shape[0]).astype(dtype)
    x = rng.standard_normal(300).astype(dtype)
    At = tcommon._ctors("torch", "cpu")[0]((vals, idx, ptr), shape=(300, 300))
    Aj = jsparse.csr_array((vals, idx, ptr), shape=(300, 300))
    y = torch.zeros(300, dtype=At.dtype)
    for use_out in (False, True):
        got = tspmv.spmv_dispatch(At, torch.from_numpy(x), y, 0, False,
                                  use_out)
        if dtype == "float32":
            assert At.spmv_path == "dia-kernel"
            np.testing.assert_array_equal(got.numpy(), np.asarray(Aj @ x))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(Aj @ x),
                                       rtol=1e-15, atol=0)


def test_spmv_microbenchmark_reads_a_file(tmp_path, capsys):
    M = sp.random(150, 120, density=0.05, random_state=np.random.default_rng(
        4), format="csr")
    path = str(tmp_path / "m.mtx")
    scipy.io.mmwrite(path, M)
    for argv in (CPU, ["--package", "scipy"]):
        rec, = tspmv.main(argv + ["-f", path, "-i", "2"])
        y = rec["y"].numpy() if hasattr(rec["y"], "numpy") else rec["y"]
        np.testing.assert_allclose(y, M @ np.ones(120), rtol=1e-12)
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


@pytest.mark.parametrize("stable", [True, False])
def test_spgemm_microbenchmark_matches_jax(example, capsys, stable):
    common, _ = example
    h = tcommon.parse_common_args(CPU)
    rec = tspgemm.run_spgemm(256, 5, "", "", 2, stable, h)
    Aj = common.banded_matrix(256, 5)
    _same_parts(Aj @ Aj.copy(), rec["C"])
    assert rec["path"] == "dia-torch"       # f64: the kernel's plain twin
    out = capsys.readouterr().out
    assert re.search(r"SPGEMM \(256, 256\)x\(256, 256\) , nnz \(1274\)x"
                     r"\(1274\)->\(2284\) : ms / iteration: [0-9.e+-]+", out)


def test_spgemm_microbenchmark_reads_a_file(tmp_path):
    """``--filename1`` alone squares the file's matrix (B = A.copy()),
    fresh matrices an iteration; ESC on both sides, bit for bit."""
    import legate_sparse_tpu as jsparse

    M = sp.random(60, 60, density=0.1, random_state=np.random.default_rng(6),
                  format="csr")
    path = str(tmp_path / "a.mtx")
    scipy.io.mmwrite(path, M)
    rec = tspgemm.run_spgemm(0, 5, path, "", 1, False,
                             tcommon.parse_common_args(CPU))
    assert rec["path"] == "esc"
    A = jsparse.mmread(path)
    _same_parts(A @ A.copy(), rec["C"])


def test_spectral_pipeline_matches_jax_and_scipy(example):
    """n = 400, 4 clusters (p_in 0.05, p_out 0.002: connected, so no
    eigenvalue of high multiplicity), k = 5: the app on the port and on
    scipy, and the JAX package on the same graph."""
    import legate_sparse_tpu as jsparse
    import legate_sparse_tpu.linalg as jlinalg
    from legate_sparse_tpu import csgraph as jcsgraph

    kw = dict(p_in=0.05, p_out=0.002)       # tests/test_examples.py's graph
    got = tspectral.run(tcommon.parse_common_args(CPU), 400, 4, 5, **kw)
    ref = tspectral.run(tcommon.parse_common_args(["--package", "scipy"]),
                        400, 4, 5, **kw)
    host = tspectral.clustered_graph(400, 4, rng=np.random.default_rng(0),
                                     **kw)
    Aj = jsparse.csr_array(host)
    kj, lj = jcsgraph.connected_components(Aj, directed=False)
    wj, _ = jlinalg.eigsh(jcsgraph.laplacian(Aj, normed=True), k=5,
                          which="SA")
    assert got["components"] == ref["components"] == int(kj)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_array_equal(got["labels"], np.asarray(lj))
    np.testing.assert_allclose(got["eigenvalues"], ref["eigenvalues"],
                               atol=1e-8)
    np.testing.assert_allclose(got["eigenvalues"], np.sort(np.asarray(wj)),
                               atol=1e-8)
    assert got["near_zero"] == ref["near_zero"]


def _jax_pde_operator(pde_ex, nx, ny):
    dx, dy = tpde.grid_spacing(nx, ny)
    return pde_ex.d2_mat_dirichlet_2d(nx, ny, dx, dy)


def test_pde_explicit_matches_example_arithmetic(example):
    """20 steps (2 warm-up) of ``p' = p + tau (A p - b)`` on a 34x30 grid,
    f64: the JAX package running the example's update agrees at
    1e-12."""
    _, pde_ex = example
    nx, ny, steps = 34, 30, 20
    out = tpde.explicit(nx, ny, steps, None, device="cpu")
    assert out["warmup_iters"] == 2 and out["path"].startswith("dia")
    A = _jax_pde_operator(pde_ex, nx, ny)
    dx, dy = tpde.grid_spacing(nx, ny)
    tau = 0.4 / (1.0 / dx**2 + 1.0 / dy**2)
    b = np.ones(A.shape[0])
    p = np.zeros(A.shape[0])
    for _ in range(steps):
        p = p + tau * (np.asarray(A.dot(p)) - b)
    np.testing.assert_allclose(out["x"].numpy(), p, rtol=1e-12, atol=1e-12)


def test_pde_throughput_matches_example_arithmetic(example):
    """``-t -i 80 -w 20``: the timed solve is CG on b = 1 capped at 60
    iterations; the JAX package's CG gives the same iterations and x at
    1e-12."""
    import legate_sparse_tpu.linalg as jlinalg

    _, pde_ex = example
    nx = ny = 34
    out = tpde.throughput(nx, ny, 1e-10, 80, 20, device="cpu")
    A = _jax_pde_operator(pde_ex, nx, ny)
    xj, itj = jlinalg.cg(A, np.ones(A.shape[0]), rtol=1e-10, maxiter=60)
    assert out["iters"] == int(itj) and out["max_iters"] == 60
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(xj), rtol=1e-12,
                               atol=1e-12)


PDE_GRID = (34, 30)
GMG_GRID = 32


def _pde_and_gmg_ranks(rank, world):
    """``apps.pde --distributed`` and ``apps.gmg --distributed``, both in
    f64 with ``return_x``, on the ranks of one process group."""
    return {
        "pde": tpde._distributed_rank(rank, world, *PDE_GRID, False, 1e-10,
                                      None, 0, torch.float64, True),
        "gmg": tgmg._distributed_rank(rank, world, GMG_GRID, "poisson", 3,
                                      "linear", 1e-10, 200, 1,
                                      torch.float64, False, True)}


@pytest.fixture(scope="module")
def distributed_runs():
    """One ``run_ranks`` call at 3 gloo ranks for the pde and GMG apps'
    distributed modes; rank 0's records."""
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_pde_and_gmg_ranks, 3, backend="gloo", timeout=300)[0]


def test_pde_distributed_matches_single_device(distributed_runs):
    """The port's distributed pde against its single-device solve and
    against ``examples/pde.py --distributed``'s solve run by the JAX
    package (``dist_diags`` with the example's closures, ``dist_cg``)
    on a 3-device CPU mesh: iterations equal, x within 1e-10."""
    import jax
    import jax.numpy as jnp
    from legate_sparse_tpu.parallel.dist_build import dist_diags
    from legate_sparse_tpu.parallel.dist_csr import dist_cg
    from legate_sparse_tpu.parallel.mesh import make_row_mesh

    nx, ny = PDE_GRID
    single = tpde.solve(nx, ny, tol=1e-10, device="cpu")
    dist = distributed_runs["pde"]
    assert dist["ranks"] == 3 and dist["spmv_path"] == "dia-torch"   # f64
    assert dist["iters"] == single["iters"] and dist["converged"]
    np.testing.assert_allclose(dist["x"], single["x"].numpy(), rtol=0,
                               atol=1e-10)
    dx, dy = tpde.grid_spacing(nx, ny)
    a, g = 1.0 / dx**2, 1.0 / dy**2
    m = nx - 2
    n = m * (ny - 2)

    def off1(i):
        return jnp.where((i + 1) % m == 0, 0.0, a)

    dA = dist_diags([-2.0 * a - 2.0 * g, off1, off1, g, g],
                    [0, 1, -1, m, -m], shape=(n, n),
                    mesh=make_row_mesh(jax.devices("cpu")[:3]),
                    dtype=np.float64, materialize_ell=False)
    xj, itj = dist_cg(dA, tpde.manufactured_rhs(nx, ny), rtol=1e-10)
    assert dist["iters"] == int(itj)
    np.testing.assert_allclose(dist["x"], np.asarray(xj)[:n], rtol=0,
                               atol=1e-10)


def test_spgemm_distributed_matches_single_device(capsys):
    h = tcommon.parse_common_args(CPU)
    dist = tspgemm.run_spgemm_distributed(600, 5, 2, 3, h, return_c=True)
    assert dist["path"] == "band" and dist["ranks"] == 3
    assert "SPGEMM (distributed, band) (600, 600)x(600, 600) over 3 " \
        "devices" in capsys.readouterr().out
    C = tspgemm.run_spgemm(600, 5, "", "", 1, True, h)["C"]
    for got, want in zip(dist["C"], interop.to_numpy_parts(C)):
        np.testing.assert_array_equal(got.astype(want.dtype), want)


def test_gmg_distributed_matches_single_device(distributed_runs):
    single = tgmg.solve(GMG_GRID, 3, gridop="linear", tol=1e-10,
                        device="cpu")
    dist = distributed_runs["gmg"]
    assert dist["ranks"] == 3 and dist["converged"]
    assert dist["iters"] == single["iters"]
    np.testing.assert_allclose(dist["x"], single["x"].numpy(), rtol=0,
                               atol=1e-10)


def test_gmg_diffusion_and_verbose(example, capsys):
    """``--data diffusion`` builds ``diffusion2D`` (bit for bit the
    example's); ``--verbose`` prints one true residual an iteration,
    the last at the solve's relative residual."""
    common, _ = example
    out = tgmg.solve(16, 3, gridop="linear", tol=1e-10, device="cpu",
                     data="diffusion", verbose=True, warmup=True)
    assert out["data"] == "diffusion" and out["converged"]
    _same_parts(common.diffusion2D(16), out["gmg"].A)
    res = [float(m) for m in re.findall(r"^Residual: ([0-9.e+-]+)$",
                                        capsys.readouterr().out, re.M)]
    assert len(res) == out["iters"]
    b = np.random.default_rng(0).random(256)
    assert res[-1] == pytest.approx(out["rel_residual"] * np.linalg.norm(b),
                                    rel=1e-6)
