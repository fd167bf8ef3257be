# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's distribution layer (``legate_sparse_tpu_torch.parallel``)
at 8 gloo ranks against the JAX package's on its 8-device CPU mesh.

One spawn of 8 ranks (``parallel.launch.run_ranks``, a ``FileStore``
rendezvous, a wall-clock limit) builds every case, runs it and sends
rank 0's numpy results back, then spawns of 2 and 3 ranks run a few
cases (both halo messages to one peer; a padded last shard) held to
the 8-rank results.  The ranks run in a thread while the JAX side runs
the same cases in the pytest process, its kernel routes in interpret
mode (``LEGATE_SPARSE_TPU_PALLAS_DIST=interpret``, as
``test_dist_pallas.py`` runs them), and the port's BSR route under
``settings.bsr_force`` (on the CPU the kernel wrappers run their plain
versions).  This module imports no JAX at its top: the ranks import it
to find their function, and each asserts that JAX stays out of it.

Each case is a layout and realization of ``shard_csr``: the halo
window (a masked and an exact band, f32/f64/bf16), the forced
all-gather (ELL, and the BSR route on a block-clustered matrix), the
precise plan (chosen for a matrix with one long-range row, and asked
for), the padded-CSR blocks, a rectangular matrix, ``1d-col``,
``2d-block`` on a 2x4 grid and ``auto``'s choice.  Compared:
``rows_per_shard``, ``halo``, the route label (the JAX package's
``dia-pallas``/``dia-xla`` are the port's ``dia-kernel``/``dia-torch``),
``to_csr()`` bit for bit, ``dist_spmv`` (x with inf and NaN at the
masked band's holes), ``dist_spmm`` (1d-row), ``dist_diagonal`` and
the ``op.*``/``comm.*`` counters of the calls.

Tolerances.  The DIA routes sum the diagonals in offset order in both
packages: bit for bit in f32 and f64.  The gather routes (ELL, padded
CSR, 2-d, BSR) sum a row in another order: 1e-6 (f32) and 1e-13 (f64)
of ``|A| |x|``.  bf16: the port's kernel rounds each product to bf16
and adds in f32, XLA's interpret run keeps the product in f32; 2^-7 of
``|A| |x|``.
"""

import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

WORLD = 8
GRID = 16
RANK_TIMEOUT = 240.0

# name -> (matrix, dtype, shard_csr keywords, mesh)
CASES = {
    "poisson-f32": ("poisson", "float32", {}, "row"),
    "poisson-f64": ("poisson", "float64", {}, "row"),
    "poisson-bf16": ("poisson", "bfloat16", {}, "row"),
    "poisson-bf16-f32x": ("poisson", "bfloat16", {}, "row"),
    "band-exact-f32": ("band", "float32", {}, "row"),
    "poisson-allgather-f32": ("poisson", "float32",
                              {"force_all_gather": True}, "row"),
    "clustered-bsr-f32": ("clustered", "float32",
                          {"force_all_gather": True}, "row"),
    "longrow-precise-f64": ("longrow", "float64", {}, "row"),
    "poisson-precise-f32": ("poisson", "float32", {"precise": True}, "row"),
    "random-padded-csr-f64": ("random", "float64", {"ell_max_expand": 0.0},
                              "row"),
    "rect-f64": ("rect", "float64", {}, "row"),
    "poisson-grid-1drow-f32": ("poisson", "float32", {}, "grid"),
    "poisson-1dcol-f64": ("poisson", "float64", {"layout": "1d-col"},
                          "row"),
    "poisson-2d-f32": ("poisson", "float32", {"layout": "2d-block"}, "grid"),
    "random-2d-f64": ("random", "float64", {"layout": "2d-block"}, "grid"),
    "random-auto-f64": ("random", "float64", {"layout": "auto"}, "grid"),
    "poisson-auto-f64": ("poisson", "float64", {"layout": "auto"}, "grid"),
}
ONE_D = [c for c, (_, _, kw, _) in CASES.items() if "layout" not in kw]
# dist_diagonal per realization: the DIA blocks (f32, bf16, exact band),
# precise ELL, padded CSR (the JAX package traces its diagonal anew at
# every call, so the list is short).
DIAGONAL = ("poisson-f32", "poisson-bf16", "band-exact-f32",
            "longrow-precise-f64", "random-padded-csr-f64")
PORT_PATH = {"dia-pallas": "dia-kernel", "dia-xla": "dia-torch"}


def scipy_matrix(kind: str):
    """The case's matrix in float64, from a seed."""
    rng = np.random.default_rng(7)
    n = GRID * GRID
    if kind in ("poisson", "band"):
        p1 = np.full(n - 1, -1.0)
        if kind == "poisson":      # no coupling across a grid row's end
            p1[np.arange(1, GRID) * GRID - 1] = 0.0
        far = np.full(n - GRID, -1.0)
        A = sp.diags([np.full(n, 4.0), p1, p1, far, far],
                     [0, 1, -1, GRID, -GRID], format="csr")
        A.eliminate_zeros()
        return A
    if kind == "clustered":
        rows, nbr = 2048, 16
        bc = np.stack([np.sort(rng.choice(nbr, 2, replace=False))
                       for _ in range(nbr)])
        r = np.repeat(np.arange(rows), 2 * 3)
        c = (np.repeat(bc, 128, axis=0)[:, :, None] * 128
             + rng.integers(0, 128, (rows, 2, 3))).reshape(-1)
        A = sp.csr_matrix((rng.standard_normal(r.size), (r, c)),
                          shape=(rows, rows))
        A.sum_duplicates()
        return A
    if kind == "longrow":
        A = sp.diags([np.full(n, 3.0), np.full(n - 1, -1.0),
                      np.full(n - 1, -1.0)], [0, 1, -1], format="lil")
        A[5, n - 6] = 0.5
        return A.tocsr()
    if kind == "random":
        return sp.random(n, n, density=0.03, format="csr", random_state=rng)
    if kind == "rect":
        return sp.random(n, 200, density=0.05, format="csr",
                         random_state=rng)
    raise ValueError(kind)


def case_inputs(name: str):
    """(scipy matrix f64, x, X) of a case; x carries inf and NaN at the
    columns the masked band's holes would read."""
    kind = CASES[name][0]
    A = scipy_matrix(kind)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(A.shape[1])
    if kind == "poisson":
        holes = np.arange(1, GRID) * GRID
        x[holes[::3]] = np.inf
        x[holes[1::3]] = np.nan
    X = rng.standard_normal((A.shape[1], 4))
    return A, x, X


def x_dtype(name: str) -> str:
    return "float32" if name.endswith("-f32x") else CASES[name][1]


# ------------------------------------------------------------- the ranks --

def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _ranks(rank, world):
    """Every case on this rank; rank 0's results (numpy) go back."""
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import obs, parallel as P, runtime
    from legate_sparse_tpu_torch.parallel import dist_csr as D
    from legate_sparse_tpu_torch.settings import settings

    runtime.set_device("cpu")
    settings.bsr_force = True
    meshes = {"row": P.make_row_mesh(), "grid": P.make_grid_mesh(2, 4)}
    out = {}
    for name, (kind, dtype, kw, mesh_kind) in CASES.items():
        A_sp, x, X = case_inputs(name)
        tdt = getattr(torch, dtype)
        A = tsparse.csr_array(A_sp.astype(np.float32 if dtype == "bfloat16"
                                          else dtype),
                              device="cpu").astype(tdt)
        obs.reset_all()
        dA = P.shard_csr(A, mesh=meshes[mesh_kind], **kw)
        res = {"rps": dA.rows_per_shard, "halo": dA.halo,
               "layout": dA.layout, "grid": dA.grid}
        S = dA.to_csr().toscipy()
        res["csr"] = (S.indptr, S.indices, S.data)
        xd = getattr(torch, x_dtype(name))
        xs = D.shard_vector(torch.from_numpy(x).to(xd), dA.mesh,
                            dA.cols_padded if dA.grid else dA.rows_padded,
                            layout=dA.layout)
        c0 = obs.counters.snapshot()
        y = P.dist_spmv(dA, xs)
        res["path"] = dA.spmv_path
        res["counters"] = {k: v - c0.get(k, 0) for k, v in
                           obs.counters.snapshot().items()
                           if k.startswith(("op.", "comm."))
                           and v != c0.get(k, 0)}
        res["y"] = _np(y.full_tensor())
        if dA.grid is None:
            Xs = P.shard_dense(torch.from_numpy(X).to(xd), dA.mesh,
                               dA.rows_padded)
            c0 = obs.counters.snapshot()
            res["Y"] = _np(P.dist_spmm(dA, Xs).full_tensor())
            res["spmm_path"] = dA.spmm_path
            res["spmm_counters"] = {
                k: v - c0.get(k, 0) for k, v in
                obs.counters.snapshot().items()
                if k.startswith(("op.", "comm.")) and v != c0.get(k, 0)}
            if name in DIAGONAL:
                res["diag"] = _np(P.dist_diagonal(dA).full_tensor())
        res["fingerprint"] = P.dist_plan_fingerprint(dA)
        out[name] = res
    # The sharded constructors against shard_csr of the same matrix.
    N = GRID
    dP = P.dist_poisson2d(N, mesh=meshes["row"], dtype=np.float64)
    dPl = P.dist_poisson2d(N, mesh=meshes["row"], dtype=np.float32,
                           materialize_ell=False)
    n = N * N
    rng = np.random.default_rng(3)
    arr = [rng.standard_normal(n - abs(k)) for k in (-2, 3)]
    dD = P.dist_diags([arr[0], lambda i: 0.5 + (i % 7).double(), 2.0,
                       arr[1]], [-2, 1, 0, 3], shape=(n, n),
                      mesh=meshes["row"])
    x = np.random.default_rng(5).standard_normal(n)
    constructors = {}
    for key, dB in (("poisson2d", dP), ("poisson2d-lean-f32", dPl),
                    ("diags", dD)):
        S = dB.to_csr().toscipy()
        xs = D.shard_vector(torch.from_numpy(x).to(dB.dtype), dB.mesh,
                            dB.rows_padded)
        constructors[key] = {"csr": (S.indptr, S.indices, S.data),
                         "y": _np(P.dist_spmv(dB, xs).full_tensor()),
                         "path": dB.spmv_path, "halo": dB.halo,
                         "rps": dB.rows_per_shard,
                         "diag": _np(P.dist_diagonal(dB).full_tensor())}
    out["constructors"] = constructors
    out["mesh_fingerprint"] = P.mesh_fingerprint(meshes["row"])
    return out if rank == 0 else None


# Fewer ranks: at 2 both halo messages go to one peer (told apart by
# their tags), at 3 the last shard holds padding rows (256 = 3 * 86 - 2).
SMALL_WORLDS = (2, 3)
SMALL_CASES = ("poisson-f32", "poisson-f64", "random-padded-csr-f64")


def _small_ranks(rank, world):
    """dist_spmv of SMALL_CASES and dist_cg on a ``world``-rank mesh."""
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import parallel as P, runtime
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    runtime.set_device("cpu")
    mesh = P.make_row_mesh()
    out = {}
    for name in SMALL_CASES:
        kind, dtype, kw, _ = CASES[name]
        A_sp, x, _ = case_inputs(name)
        dA = P.shard_csr(tsparse.csr_array(A_sp.astype(dtype), device="cpu"),
                         mesh=mesh, **kw)
        xs = D.shard_vector(torch.from_numpy(x).to(getattr(torch, dtype)),
                            mesh, dA.rows_padded)
        out[name] = {"y": _np(P.dist_spmv(dA, xs).full_tensor()),
                     "path": dA.spmv_path, "halo": dA.halo,
                     "rps": dA.rows_per_shard}
    dA = P.shard_csr(tsparse.csr_array(scipy_matrix("poisson"), device="cpu"),
                     mesh=mesh)
    xsol, it = P.dist_cg(dA, np.ones(GRID * GRID), rtol=1e-10)
    out["cg"] = (xsol.full_tensor().numpy(), it)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def port_launch():
    """The launches of 8, then 2 and 3 ranks, one after another in a
    thread that starts before the JAX side runs; collected after it."""
    from concurrent.futures import ThreadPoolExecutor

    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    limits = {WORLD: RANK_TIMEOUT}
    limits.update((world, RANK_TIMEOUT / 2) for world in SMALL_WORLDS)
    with ThreadPoolExecutor(1) as pool:
        yield {world: pool.submit(run_ranks,
                                  _ranks if world == WORLD else _small_ranks,
                                  world, backend="gloo", timeout=limit,
                                  threads=1)
               for world, limit in limits.items()}


@pytest.fixture(scope="module")
def port(port_launch, jax_side):
    return port_launch[WORLD].result()[0]


@pytest.fixture(scope="module")
def port_small(port_launch, jax_side):
    return {world: port_launch[world].result()[0] for world in SMALL_WORLDS}


# ---------------------------------------------------------- the JAX side --

@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    import legate_sparse_tpu as jsparse
    from legate_sparse_tpu import obs as jobs
    from legate_sparse_tpu.parallel import (
        dist_diagonal, dist_diags, dist_poisson2d, dist_spmm, dist_spmv,
        make_grid_mesh, make_row_mesh, mesh_fingerprint, shard_csr,
        shard_dense)
    from legate_sparse_tpu.parallel.dist_csr import shard_vector

    devs = jax.devices("cpu")
    if len(devs) < WORLD:
        pytest.skip("needs 8 virtual devices")
    meshes = {"row": make_row_mesh(devs[:WORLD]),
              "grid": make_grid_mesh(devs[:WORLD], shape=(2, 4))}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LEGATE_SPARSE_TPU_PALLAS_DIST", "interpret")
        jobs.enable()
        for name, (kind, dtype, kw, mesh_kind) in CASES.items():
            A_sp, x, X = case_inputs(name)
            jdt = jnp.bfloat16 if dtype == "bfloat16" else dtype
            A = jsparse.csr_array(A_sp.astype(
                np.float32 if dtype == "bfloat16" else dtype)).astype(jdt)
            jobs.reset_all()
            dA = shard_csr(A, mesh=meshes[mesh_kind], **kw)
            res = {"rps": dA.rows_per_shard, "halo": dA.halo,
                   "layout": dA.layout, "grid": dA.grid}
            S = dA.to_csr().toscipy()
            res["csr"] = (S.indptr, S.indices, S.data)
            xd = jnp.float32 if name.endswith("-f32x") else jdt
            xs = shard_vector(jnp.asarray(x, xd), dA.mesh,
                              dA.cols_padded if dA.grid else dA.rows_padded,
                              layout=dA.layout)
            jobs.trace.reset()
            c0 = jobs.snapshot()
            y = dist_spmv(dA, xs)
            spans = [r for r in jobs.records()
                     if r.get("name") == "dist_spmv"]
            res["path"] = spans[-1]["attrs"]["path"]
            res["counters"] = {k: v - c0.get(k, 0) for k, v in
                               jobs.snapshot().items()
                               if k.startswith(("op.", "comm."))
                               and v != c0.get(k, 0)}
            res["y"] = np.asarray(y.astype(jnp.float32)
                                  if y.dtype == jnp.bfloat16 else y)
            if dA.grid is None:
                Xs = shard_dense(jnp.asarray(X, xd), dA.mesh, dA.rows_padded)
                c0 = jobs.snapshot()
                Y = dist_spmm(dA, Xs)
                res["Y"] = np.asarray(Y.astype(jnp.float32)
                                      if Y.dtype == jnp.bfloat16 else Y)
                res["spmm_counters"] = {
                    k: v - c0.get(k, 0) for k, v in jobs.snapshot().items()
                    if k.startswith(("op.", "comm.")) and v != c0.get(k, 0)}
                if name in DIAGONAL:
                    d = dist_diagonal(dA)
                    res["diag"] = np.asarray(
                        d.astype(jnp.float32) if d.dtype == jnp.bfloat16
                        else d)
            out[name] = res
        jobs.disable()
        jobs.reset_all()
        N = GRID
        n = N * N
        dP = dist_poisson2d(N, mesh=meshes["row"], dtype=np.float64)
        dPl = dist_poisson2d(N, mesh=meshes["row"], dtype=np.float32,
                             materialize_ell=False)
        rng = np.random.default_rng(3)
        arr = [rng.standard_normal(n - abs(k)) for k in (-2, 3)]
        dD = dist_diags([arr[0], lambda i: 0.5 + (i % 7).astype(jnp.float64),
                         2.0, arr[1]], [-2, 1, 0, 3], shape=(n, n),
                        mesh=meshes["row"])
        x = np.random.default_rng(5).standard_normal(n)
        constructors = {}
        for key, dB in (("poisson2d", dP), ("poisson2d-lean-f32", dPl),
                        ("diags", dD)):
            S = dB.to_csr().toscipy()
            xs = shard_vector(jnp.asarray(x, dB.dtype), dB.mesh,
                              dB.rows_padded)
            constructors[key] = {"csr": (S.indptr, S.indices, S.data),
                             "y": np.asarray(dist_spmv(dB, xs)),
                             "halo": dB.halo, "rps": dB.rows_per_shard,
                             "diag": np.asarray(dist_diagonal(dB))}
        out["constructors"] = constructors
        out["mesh_fingerprint"] = mesh_fingerprint(meshes["row"])
    return out


# ----------------------------------------------------------------- tests --

def _same_csr(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _hold(name, got, want, A_sp, x, path, what):
    """``got`` against ``want``: bit for bit on the DIA routes in f32 and
    f64, else within the stated fraction of ``|A| |x|``; NaN and inf
    where the JAX package has them."""
    n = A_sp.shape[0]
    got, want = np.asarray(got)[:n], np.asarray(want)[:n]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), what)
    dtype = CASES[name][1]
    if path.startswith("dia") and dtype != "bfloat16":
        np.testing.assert_array_equal(got, want, what)
        return
    fin = np.isfinite(want)
    mag = abs(A_sp) @ np.where(np.isfinite(x), np.abs(x), 0.0)
    rel = {"float32": 1e-6, "float64": 1e-13, "bfloat16": 2.0 ** -7}[dtype]
    assert np.all(np.abs(got[fin] - want[fin]) <= rel * mag[fin] + 1e-30), \
        what


@pytest.mark.parametrize("name", sorted(CASES))
def test_shard_structure(port, jax_side, name):
    """rows_per_shard, halo, the layout and grid, and the route label."""
    p, j = port[name], jax_side[name]
    assert (p["rps"], p["halo"], p["layout"]) == (j["rps"], j["halo"],
                                                  j["layout"])
    assert p["grid"] == (tuple(j["grid"]) if j["grid"] else None)
    assert p["path"] == PORT_PATH.get(j["path"], j["path"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_to_csr_bitwise(port, jax_side, name):
    _same_csr(port[name]["csr"], jax_side[name]["csr"])
    A_sp = scipy_matrix(CASES[name][0])
    S = sp.csr_matrix(port[name]["csr"][::-1], shape=A_sp.shape)
    assert S.nnz == A_sp.nnz


@pytest.mark.parametrize("name", sorted(CASES))
def test_dist_spmv(port, jax_side, name):
    A_sp, x, _ = case_inputs(name)
    _hold(name, port[name]["y"], jax_side[name]["y"], A_sp, x,
          port[name]["path"], f"{name}: dist_spmv")


@pytest.mark.parametrize("name", sorted(ONE_D))
def test_dist_spmm_and_diagonal(port, jax_side, name):
    A_sp, _, X = case_inputs(name)
    p, j = port[name], jax_side[name]
    _hold(name, p["Y"], j["Y"], A_sp, X, p["spmm_path"],
          f"{name}: dist_spmm")
    if "diag" in j:
        np.testing.assert_array_equal(p["diag"], j["diag"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_counters(port, jax_side, name):
    """``op.*`` and ``comm.*`` of one dist_spmv (and dist_spmm) equal the
    JAX package's, which an eager call records once."""
    assert port[name]["counters"] == jax_side[name]["counters"]
    if "spmm_counters" in jax_side[name]:
        assert port[name]["spmm_counters"] == jax_side[name]["spmm_counters"]


@pytest.mark.parametrize("key", ["poisson2d", "poisson2d-lean-f32", "diags"])
def test_sharded_constructors(port, jax_side, key):
    """dist_diags/dist_poisson2d: the same matrix as the JAX package's
    constructors (and, for Poisson, as ``shard_csr`` of the scipy
    matrix), the same halo, SpMV bit for bit on the DIA route."""
    p, j = port["constructors"][key], jax_side["constructors"][key]
    _same_csr(p["csr"], j["csr"])
    assert (p["halo"], p["rps"]) == (j["halo"], j["rps"])
    assert p["path"] == ("dia-torch" if key in ("poisson2d", "diags")
                         else "dia-kernel")
    np.testing.assert_array_equal(p["y"], j["y"])
    np.testing.assert_array_equal(p["diag"], j["diag"])
    if key == "poisson2d":
        # The constructor stores the boundary's zeros; the values are those of
        # shard_csr(diags(...)).
        S = sp.csr_matrix(p["csr"][::-1], shape=(GRID ** 2,) * 2)
        S.eliminate_zeros()
        _same_csr((S.indptr, S.indices, S.data), port["poisson-f64"]["csr"])


@pytest.mark.parametrize("world", SMALL_WORLDS)
@pytest.mark.parametrize("name", SMALL_CASES)
def test_fewer_ranks(port, port_small, world, name):
    """The ring-wrapped halo at 2 ranks (both neighbours one peer, the
    halo up to a whole block) and the padded last shard at 3: the same y
    as at 8 ranks (bit for bit on the DIA routes, which sum each row in
    offset order whatever the shard count)."""
    p, p8 = port_small[world][name], port[name]
    n = GRID * GRID
    if name.startswith("poisson"):
        assert p["halo"] == p8["halo"] and p["path"] == p8["path"]
    else:
        # 2 ranks: every column within one neighbour block, the halo is a
        # whole block (128); 3: the all-gather, as at 8.
        assert p["halo"] == {2: 128, 3: -1}[world]
        assert p["path"] == "padded-csr"
    assert p["rps"] == -(-n // world)
    A_sp, x, _ = case_inputs(name)
    _hold(name, p["y"], p8["y"], A_sp, x, p["path"],
          f"{name} at {world} ranks against 8")


@pytest.mark.parametrize("world", SMALL_WORLDS)
def test_fewer_ranks_cg(port_small, world):
    """dist_cg at 2 and 3 ranks (padding rows in the Krylov vectors)
    against scipy's direct solve."""
    from scipy.sparse.linalg import spsolve

    xp, _ = port_small[world]["cg"]
    A = scipy_matrix("poisson")
    x_ref = spsolve(A.tocsc(), np.ones(A.shape[0]))
    assert np.linalg.norm(xp - x_ref) <= 1e-8 * np.linalg.norm(x_ref)


def test_mesh_fingerprint(port, jax_side):
    """The 8-rank gloo mesh and the 8-device CPU mesh have one
    fingerprint: axis names, shape and (platform, id) of each member."""
    assert port["mesh_fingerprint"] == jax_side["mesh_fingerprint"]


# ------------------------------------------------------------ the launcher --

def _raise(rank, world):
    import time

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(3600)


def _hang(rank, world):
    import time

    time.sleep(3600)


@pytest.mark.parametrize("fn, world, timeout, err", [
    (_raise, 2, RANK_TIMEOUT / 2, RuntimeError),
    (_hang, 1, 6.0, TimeoutError)])
def test_launcher_stops_ranks(fn, world, timeout, err):
    """A rank that raises stops the launch with its traceback, and the
    rank still running is killed; a rank that does not return within the
    limit is killed."""
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    t0 = time.monotonic()
    with pytest.raises(err) as info:
        run_ranks(fn, world, backend="gloo", timeout=timeout, threads=1)
    if err is RuntimeError:
        assert "rank 1 fails on purpose" in str(info.value)
        assert time.monotonic() - t0 < timeout


def test_no_fallback_to_the_cpu(monkeypatch):
    """Without a CUDA device and without a request for the CPU,
    ``init_distributed`` raises (it never picks gloo by itself), and
    nothing builds a mesh before a process group exists."""
    import torch.distributed as dist

    from legate_sparse_tpu_torch import parallel as P, runtime

    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runtime.set_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.init_distributed()
    with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA"):
        P.init_distributed(backend="nccl")
    with pytest.raises(RuntimeError, match="init_distributed"):
        P.make_row_mesh()

    # run_ranks with no backend picks as init_distributed does: it
    # raises before it starts a rank, and never starts gloo ranks.
    import multiprocessing

    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    def no_spawn(*args, **kwargs):
        raise AssertionError("run_ranks started ranks")

    monkeypatch.setattr(multiprocessing, "get_context", no_spawn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(_hang, 2, timeout=6.0)
    assert not dist.is_initialized()


def test_meshes_follow_the_process_group(tmp_path):
    """Meshes and ring neighbours are cached for the job's process group
    only: after ``destroy_process_group`` and a second
    ``init_distributed`` in one process, ``make_row_mesh`` builds a new
    mesh, and its group runs a collective (one gloo rank here)."""
    import torch.distributed as dist

    from legate_sparse_tpu_torch import parallel as P
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    meshes = []
    try:
        for k in range(2):
            P.init_distributed(backend="gloo",
                               init_method=f"file://{tmp_path}/store{k}",
                               world_size=1, rank=0, timeout=60)
            mesh = P.make_row_mesh()
            assert P.make_row_mesh() is mesh
            group = mesh.get_group("rows")
            assert D._ring(group) == (1, 0, 0)
            t = torch.full((3,), 2.0)
            dist.all_reduce(t, group=group)
            assert torch.equal(t, torch.full((3,), 2.0))
            meshes.append(mesh)
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert meshes[0] is not meshes[1]
