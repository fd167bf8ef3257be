# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's distributed solvers (``dist_cg``, ``dist_gmres``,
``dist_bicgstab``, ``dist_minres``, ``dist_eigsh``) at 8 gloo ranks
against the JAX package's on its 8-device CPU mesh.

The port reuses the single-device loops (``linalg._cg_loop``,
``_gmres_loop``, ``_bicgstab_loop``, ``krylov_extra._minres_loop``,
``eigen._lanczos_eigsh``) over each rank's blocks, with every inner
product and norm all-reduced (``linalg.reduce_over``); the JAX package
runs the same loops on global arrays, its reductions lowered to
``psum``.  One spawn of 8 ranks runs every case (``run_ranks``; this
module imports no JAX at its top, and each rank asserts it holds
none).

Operators (numpy, from a seed): the 2-D Poisson operator on a 16x16
grid (SPD; shifted by 2 it is indefinite, for MINRES) and an upwinded
convection-diffusion operator on the same grid (nonsymmetric), both
banded, so the SpMVs take the DIA route.  Tolerances: iteration counts
equal; x within 1e-10 (f64) and 1e-5 (f32) of the JAX package's,
relative to its norm (the two sum a dot product in another order:
local sums then an all-reduce against XLA's); ``dist_eigsh``'s
eigenvalues within 1e-6.  The port's ``comm.dist_<solver>.psum``
counts the all-reduces its loop ran, checked against the count the
iteration count implies.
"""

import numpy as np
import pytest
import scipy.sparse as sp

WORLD = 8
GRID = 16
RANK_TIMEOUT = 240.0

# name -> (solver, operator, dtype, keywords)
CASES = {
    "cg-f64": ("cg", "poisson", "float64", {"rtol": 1e-8}),
    "cg-f32": ("cg", "poisson", "float32", {"rtol": 1e-5}),
    "cg-callback-f64": ("cg", "poisson", "float64",
                        {"rtol": 1e-8, "callback": True}),
    "cg-2d-f64": ("cg", "poisson-2d", "float64", {"rtol": 1e-8}),
    "gmres-f64": ("gmres", "convdiff", "float64",
                  {"rtol": 1e-8, "restart": 20}),
    "gmres-f32": ("gmres", "convdiff", "float32",
                  {"rtol": 1e-5, "restart": 20}),
    "bicgstab-f64": ("bicgstab", "convdiff", "float64", {"rtol": 1e-8}),
    "bicgstab-f32": ("bicgstab", "convdiff", "float32", {"rtol": 1e-5}),
    "minres-f64": ("minres", "poisson", "float64",
                   {"rtol": 1e-8, "shift": 2.0}),
    "minres-f32": ("minres", "poisson", "float32",
                   {"rtol": 1e-5, "shift": 2.0}),
}
# name -> (which, sigma, grid): Lanczos at both ends, and shift-invert at
# 0.5, whose every Lanczos step is an inner MINRES solve over the ranks
# (on an 8x8 grid, to keep its all-reduces few).
EIGSH = {"eigsh-LA": ("LA", None, GRID), "eigsh-SA": ("SA", None, GRID),
         "eigsh-sigma": ("LM", 0.5, 8)}


def operator(kind: str, grid: int = GRID):
    n = grid * grid
    cut = np.ones(n - 1)
    cut[np.arange(1, grid) * grid - 1] = 0.0
    far = np.full(n - grid, -1.0)
    if kind == "convdiff":
        diags = [np.full(n, 4.0), -1.5 * cut, -0.5 * cut, far, far]
    else:
        diags = [np.full(n, 4.0), -cut, -cut, far, far]
    A = sp.diags(diags, [0, -1, 1, grid, -grid], format="csr")
    A.eliminate_zeros()
    return A


def rhs():
    return np.random.default_rng(3).standard_normal(GRID * GRID)


# ------------------------------------------------------------- the ranks --

def _psum_calls(counters, op):
    return counters.get(f"comm.{op}.psum", 0)


def _ranks(rank, world):
    import torch

    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import linalg, obs, parallel as P, runtime

    runtime.set_device("cpu")
    meshes = {"row": P.make_row_mesh(), "grid": P.make_grid_mesh(2, 4)}
    out = {}
    for name, (solver, kind, dtype, kw) in CASES.items():
        kw = dict(kw)
        A = tsparse.csr_array(operator(kind.split("-")[0]).astype(dtype),
                              device="cpu")
        if kind.endswith("-2d"):
            dA = P.shard_csr(A, mesh=meshes["grid"], layout="2d-block")
        else:
            dA = P.shard_csr(A, mesh=meshes["row"])
        b = rhs().astype(dtype)
        seen = []
        if kw.pop("callback", False):
            kw["callback"] = lambda xk: seen.append(tuple(xk.shape))
        fn = getattr(P, "dist_" + solver)
        obs.reset_all()
        x, iters = fn(dA, b, **kw)
        snap = obs.counters.snapshot()
        out[name] = {"x": x.full_tensor().numpy(), "iters": int(iters),
                     "psum": _psum_calls(snap, "dist_" + solver),
                     "spmv": snap.get("op.dist_spmv", 0),
                     "callbacks": seen}
    # Block Jacobi on the Poisson operator: each rank solves its diagonal
    # block by a local cg (inside dist_cg, so its reductions must stay on
    # the rank) or by a dense solve.
    A_sp = operator("poisson")
    lo, hi = rank * A_sp.shape[0] // world, (rank + 1) * A_sp.shape[0] // world
    blk = A_sp[lo:hi, lo:hi]
    B = tsparse.csr_array(blk, device="cpu")
    Bd = torch.from_numpy(blk.toarray())
    dA = P.shard_csr(tsparse.csr_array(A_sp, device="cpu"),
                     mesh=meshes["row"])
    for key, M in (("inner-cg", lambda r: linalg.cg(B, r, rtol=1e-13)[0]),
                   ("dense", lambda r: torch.linalg.solve(Bd, r))):
        obs.reset_all()
        x, iters = P.dist_cg(dA, rhs(), rtol=1e-8, M=M)
        out["block-jacobi-" + key] = {
            "x": x.full_tensor().numpy(), "iters": int(iters),
            "psum": _psum_calls(obs.counters.snapshot(), "dist_cg")}
    for name, (which, sigma, grid) in EIGSH.items():
        dA = P.shard_csr(tsparse.csr_array(operator("poisson", grid),
                                           device="cpu"), mesh=meshes["row"])
        w, X = P.dist_eigsh(dA, k=4, which=which, sigma=sigma)
        out[name] = {"w": w.numpy(), "X": X.full_tensor().numpy()}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def port_launch():
    """The 8 ranks, started before the JAX side runs and collected after
    it (a thread waits on them meanwhile)."""
    from concurrent.futures import ThreadPoolExecutor

    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _ranks, WORLD, backend="gloo",
                          timeout=RANK_TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def port(port_launch, jax_side):
    return port_launch.result()[0]


@pytest.fixture(scope="module")
def jax_side():
    import jax

    import legate_sparse_tpu as jsparse
    from legate_sparse_tpu import parallel as JP

    devs = jax.devices("cpu")
    if len(devs) < WORLD:
        pytest.skip("needs 8 virtual devices")
    meshes = {"row": JP.make_row_mesh(devs[:WORLD]),
              "grid": JP.make_grid_mesh(devs[:WORLD], shape=(2, 4))}
    out = {}
    for name, (solver, kind, dtype, kw) in CASES.items():
        kw = dict(kw)
        A = jsparse.csr_array(operator(kind.split("-")[0]).astype(dtype))
        if kind.endswith("-2d"):
            dA = JP.shard_csr(A, mesh=meshes["grid"], layout="2d-block")
        else:
            dA = JP.shard_csr(A, mesh=meshes["row"])
        seen = []
        if kw.pop("callback", False):
            kw["callback"] = lambda xk: seen.append(tuple(xk.shape))
        x, iters = getattr(JP, "dist_" + solver)(
            dA, rhs().astype(dtype), **kw)
        out[name] = {"x": np.asarray(x), "iters": int(iters),
                     "callbacks": seen}
    for name, (which, sigma, grid) in EIGSH.items():
        dA = JP.shard_csr(jsparse.csr_array(operator("poisson", grid)),
                          mesh=meshes["row"])
        w, X = JP.dist_eigsh(dA, k=4, which=which, sigma=sigma)
        out[name] = {"w": np.asarray(w), "X": np.asarray(X)}
    return out


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("name", sorted(CASES))
def test_solution_and_iterations(port, jax_side, name):
    solver, kind, dtype, kw = CASES[name]
    p, j = port[name], jax_side[name]
    assert p["iters"] == j["iters"]
    tol = 1e-10 if dtype == "float64" else 1e-5
    err = np.linalg.norm(p["x"] - j["x"]) / np.linalg.norm(j["x"])
    assert err <= tol, f"{name}: relative difference {err}"
    A = operator(kind.split("-")[0])
    if solver == "minres":
        A = A - kw["shift"] * sp.eye(A.shape[0])
    b = rhs()
    res = np.linalg.norm(A @ p["x"].astype(np.float64) - b) / np.linalg.norm(b)
    assert res <= (2e-8 if dtype == "float64" else 1e-4), res
    assert p["callbacks"] == j["callbacks"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_reductions_counted(port, name):
    """The all-reduces of the solve: ``‖b‖`` once, then the loop's own
    (CG: two an iteration and one a convergence test; GMRES: a cycle's
    ``restart (restart + 1) / 2 + restart + 1`` plus one for each
    suspected convergence it confirms), each recorded as
    ``comm.dist_<solver>.psum``; and one ``op.dist_spmv`` per SpMV."""
    solver, kind, dtype, kw = CASES[name]
    p = port[name]
    it = p["iters"]
    if solver == "cg":
        tests = sum(1 for i in range(1, it + 1)
                    if i % 25 == 0 or i == GRID * GRID * 10 - 1)
        assert p["psum"] == 1 + 2 * it + tests
        assert p["spmv"] == it + 1
    elif solver == "gmres":
        # A cycle that finds the residual converged at its start ends
        # the solve without counting iterations.
        r = kw["restart"]
        per = r * (r + 1) // 2 + r + 1
        assert any(0 <= p["psum"] - 1 - c * per <= c
                   for c in (it // r, it // r + 1))
    else:
        assert p["psum"] > it


@pytest.mark.parametrize("name", sorted(EIGSH))
def test_dist_eigsh(port, jax_side, name):
    p, j = port[name], jax_side[name]
    np.testing.assert_allclose(p["w"], j["w"], rtol=1e-6, atol=1e-6)
    grid = EIGSH[name][2]
    A = operator("poisson", grid)
    X = p["X"]
    assert X.shape == (grid * grid, 4)
    resid = np.linalg.norm(A @ X - X * p["w"][None, :], axis=0)
    assert np.all(resid <= 1e-6 * np.abs(p["w"]).max())


def test_block_jacobi_inner_cg(port):
    """A preconditioner that runs a local ``linalg.cg`` on the rank's
    diagonal block inside ``dist_cg``: the inner solve's inner products
    stay on the rank (the solve makes the all-reduces of the one whose
    block solve is dense, ``1 + 2 it + tests``), and the two solves agree
    in iterations and, at 1e-10, in x."""
    p, d = port["block-jacobi-inner-cg"], port["block-jacobi-dense"]
    it = d["iters"]
    assert p["iters"] == it
    tests = sum(1 for i in range(1, it + 1)
                if i % 25 == 0 or i == GRID * GRID * 10 - 1)
    assert p["psum"] == d["psum"] == 1 + 2 * it + tests
    err = np.linalg.norm(p["x"] - d["x"]) / np.linalg.norm(d["x"])
    assert err <= 1e-10, err
    b = rhs()
    res = np.linalg.norm(operator("poisson") @ p["x"] - b) / np.linalg.norm(b)
    assert res <= 2e-8, res
