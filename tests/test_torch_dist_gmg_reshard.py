# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``DistGMG``, ``reshard``/``reshard_vector``/
``chunk_permute_plan``, ``dist_minres(callback=)`` and the distributed
compressed storage at 8 gloo ranks against the JAX package's on its
8-device CPU mesh.

One spawn of 8 ranks (``parallel.launch.run_ranks``) runs every case
and sends rank 0's numpy results back while the JAX side runs the same
cases in the pytest process (this module imports no JAX at its top:
the ranks import it to find their function).

- ``DistGMG`` (``tests/test_dist_gmg.py``): the 16x16 Poisson operator
  (f64), 3 levels, injection and linear transfers, preconditioning
  ``dist_cg`` to rtol 1e-10.  Iteration counts equal; x within 1e-6 of
  the JAX package's, relative to its norm (the power iteration's and
  the solve's dots are all-reduced in another order than XLA's); every
  coarse operator bit for bit (the Galerkin products are the ESC of
  ``test_torch_dist_spgemm.py``); ``cycle_comm_volumes`` equal.
- ``dist_minres(callback=)``: both packages run scipy's host loop on
  the padded operator; iteration and callback counts equal, x within
  1e-10.
- Compressed storage (``tests/test_compressed_storage.py:373-404``): a
  96x96 random matrix ``compress()``ed, sharded 1d-row, 1d-col and
  2d-block: ``dist_spmv`` of an f32 x returns f32 within 1e-5 (and
  1e-6 absolute) of the local ``C @ x`` and of the JAX package's; the
  2-d blocks hold int16 block-local columns and bf16 values.
- ``reshard`` (``tests/test_reshard.py``): every ordered pair of
  ``1d-row``/``1d-col``/``2d-block`` against a fresh ``shard_csr`` on
  the destination (layout, grid and plan fingerprint) and SpMV against
  the local product (f32: 1e-5), and against the JAX package's
  ``reshard`` of the same pair (layout, grid, gathered entries bit for
  bit, SpMV within 1e-5); the typed errors of a matrix without
  its source, of a destination over fewer ranks (the JAX package's
  repartition waits for the survivor mesh here) and of a permuted one.
  ``reshard_vector`` onto a rotated placement and back (bit for bit,
  each chunk on the rank that owns it), its ``comm.dist_reshard.*``
  counters against ``reshard_volumes`` and the JAX package's, the
  identity placement at 0 bytes, ``chunk_permute_plan``'s pairs equal
  to the JAX package's, and plan fingerprints that change with the
  layout and the mesh.
"""

import numpy as np
import pytest
import scipy.sparse as sp

WORLD = 8
RANK_TIMEOUT = 240.0
GMG_N = 16
LAYOUTS = ("1d-row", "1d-col", "2d-block")


def poisson(N):
    n = N * N
    off1 = np.full(n - 1, -1.0)
    off1[np.arange(1, N) * N - 1] = 0.0
    offN = np.full(n - N, -1.0)
    A = sp.diags([np.full(n, 4.0), off1, off1, offN, offN],
                 [0, 1, -1, N, -N], shape=(n, n), format="csr")
    A.eliminate_zeros()
    return A


def gmg_rhs():
    return np.random.default_rng(0).random(GMG_N * GMG_N)


def compressed_source():
    rng = np.random.default_rng(13)
    return sp.random(96, 96, density=0.08, format="csr", random_state=rng)


def tridiag(n=96):
    return sp.diags([np.full(n, 4.0), np.full(n - 1, -1.0),
                     np.full(n - 1, -1.0)], [0, 1, -1], format="csr")


def x_f32(n, seed=7):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# ------------------------------------------------------------- the ranks --

def _np(t):
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _reshard_cases(P, D, tsparse, rank, world):
    """The ``reshard`` cases on this rank; rank-independent results."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from legate_sparse_tpu_torch import obs

    out = {}
    A = tsparse.csr_array(tridiag().astype(np.float32), device="cpu")
    x = x_f32(96)
    ref = _np(A @ torch.from_numpy(x))

    def y_of(M):
        xs = D.shard_vector(torch.from_numpy(x), M.mesh, M.rows_padded,
                            layout=M.layout)
        return _np(P.dist_spmv(M, xs).full_tensor())[:96]

    for src in LAYOUTS:
        for dst in LAYOUTS:
            dA = P.shard_csr(A, layout=src)
            B = P.reshard(dA, layout=dst)
            fresh = P.shard_csr(A, mesh=B.mesh, layout=B.layout)
            C = P.reshard(B, mesh=dA.mesh, layout=src)
            S = B.to_csr().toscipy()
            out[("pair", src, dst)] = {
                "same_object": B is dA, "layout": B.layout, "grid": B.grid,
                "csr": (S.indptr, S.indices, S.data), "y": y_of(B),
                "fp_fresh": P.dist_plan_fingerprint(B)
                == P.dist_plan_fingerprint(fresh),
                "fp_back": P.dist_plan_fingerprint(C)
                == P.dist_plan_fingerprint(dA),
                "err": [float(np.abs(y_of(M) - ref).max())
                        for M in (B, fresh, C)]}
    dA = P.shard_csr(A)
    dA2 = P.shard_csr(A)
    dA2._src_csr = None
    errors = {}
    try:
        P.reshard(dA2, layout="2d-block")
    except ValueError as e:
        errors["no_source"] = str(e)
    out["sibling_fast_path"] = P.reshard(dA, layout="1d-row") is dA
    small = DeviceMesh("cpu", list(range(world - 1)),
                       mesh_dim_names=("rows",), _init_backend=False)
    rot = DeviceMesh("cpu", list(range(1, world)) + [0],
                     mesh_dim_names=("rows",))
    for key, fn in (("shrink", lambda: P.reshard(dA, mesh=small)),
                    ("permuted", lambda: P.reshard(dA, mesh=rot))):
        try:
            fn()
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    out["fingerprints"] = {
        "src": P.mesh_fingerprint(dA.mesh), "small": P.mesh_fingerprint(small),
        "rot": P.mesh_fingerprint(rot),
        "plan_src": P.dist_plan_fingerprint(dA),
        "plan_2d": P.dist_plan_fingerprint(P.reshard(dA, layout="2d-block")),
        "plan_noop": P.dist_plan_fingerprint(P.reshard(dA))}

    # The vector chunk permute onto the rotated placement and back.
    mesh = P.make_row_mesh()
    n = 64 * world
    v = D.shard_vector(torch.arange(n, dtype=torch.float32), mesh, n)
    c0 = obs.counters.snapshot("comm.")
    w = P.reshard_vector(v, rot)
    c1 = obs.counters.snapshot("comm.")
    v2 = P.reshard_vector(w, mesh)
    c2 = obs.counters.snapshot("comm.")
    u = P.reshard_vector(v2, mesh)
    c3 = obs.counters.snapshot("comm.")
    try:
        P.reshard_vector(v, small)
    except ValueError as e:
        errors["vector_shrink"] = str(e)
    try:
        P.chunk_permute_plan(mesh, small)
    except ValueError as e:
        errors["plan_shrink"] = str(e)

    def delta(a, b):
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}

    out["vector"] = {
        "chunk": _np(w.to_local()),
        "rot_coord": rot.mesh.reshape(-1).tolist().index(rank),
        "back": _np(v2.to_local()), "orig": _np(v.to_local()),
        "identity": _np(u.to_local()), "counters": delta(c0, c1),
        "counters_back": delta(c1, c2), "counters_identity": delta(c2, c3),
        "plan_identity": P.chunk_permute_plan(mesh, mesh),
        "plan_rot": P.chunk_permute_plan(mesh, rot)}
    return out


def _ranks(rank, world):
    import torch

    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import obs, parallel as P, runtime
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    runtime.set_device("cpu")
    mesh = P.make_row_mesh()
    out = {}
    A = tsparse.csr_array(poisson(GMG_N), device="cpu")
    for gridop in ("injection", "linear"):
        dA = P.shard_csr(A, mesh=mesh)
        mg = P.DistGMG(dA, levels=3, gridop=gridop)
        x, iters = P.dist_cg(dA, gmg_rhs(), M=mg.cycle, rtol=1e-10,
                             maxiter=200)
        coarse = []
        for _, Ac, _ in mg.operators:
            S = Ac.to_csr().toscipy()
            coarse.append((S.indptr, S.indices, S.data))
        out[("gmg", gridop)] = {
            "x": _np(x.full_tensor()), "iters": int(iters),
            "coarse": coarse, "comm": mg.cycle_comm_volumes,
            "diagnostics": mg.diagnostics(),
            "omega": [float(o) for o, _ in mg.level_params]}
    dA = P.shard_csr(A, mesh=mesh)
    seen = []
    x, iters = P.dist_minres(dA, gmg_rhs(), rtol=1e-8,
                             callback=lambda xk: seen.append(xk.shape))
    out["minres"] = {"x": _np(x.full_tensor()), "iters": int(iters),
                     "seen": seen}

    C = tsparse.csr_array(compressed_source(), device="cpu").compress()
    xc = torch.linspace(-1.0, 1.0, 96, dtype=torch.float32)
    y_local = _np(C @ xc)
    for layout in LAYOUTS:
        m = P.make_grid_mesh(2, 4) if layout == "2d-block" else mesh
        dC = P.shard_csr(C, mesh=m, layout=layout)
        xs = D.shard_vector(xc, dC.mesh, dC.rows_padded, layout=dC.layout)
        y = P.dist_spmv(dC, xs)
        out[("compressed", layout)] = {
            "y": _np(y.full_tensor())[:96], "dtype": str(y.dtype),
            "y_local": y_local, "cols": str(dC.cols.dtype),
            "data": str(dC.data.dtype), "path": dC.spmv_path}
    obs.reset_all()
    out["reshard"] = _reshard_cases(P, D, tsparse, rank, world)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def port_launch():
    from concurrent.futures import ThreadPoolExecutor

    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _ranks, WORLD, backend="gloo",
                          timeout=RANK_TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def port(port_launch, jax_side):
    return port_launch.result()[0]


# ---------------------------------------------------------- the JAX side --

@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import legate_sparse_tpu as jsparse
    from legate_sparse_tpu import obs as jobs
    from legate_sparse_tpu import parallel as JP
    from legate_sparse_tpu.parallel.dist_csr import shard_vector

    devs = jax.devices("cpu")
    if len(devs) < WORLD:
        pytest.skip("needs 8 virtual devices")
    mesh = JP.make_row_mesh(devs[:WORLD])
    out = {}
    A = jsparse.csr_array(poisson(GMG_N))
    for gridop in ("injection", "linear"):
        dA = JP.shard_csr(A, mesh=mesh)
        mg = JP.DistGMG(dA, levels=3, gridop=gridop)
        x, iters = JP.dist_cg(dA, gmg_rhs(), M=mg.cycle, rtol=1e-10,
                              maxiter=200)
        coarse = []
        for _, Ac, _ in mg.operators:
            S = Ac.to_csr().toscipy()
            coarse.append((S.indptr, S.indices, S.data))
        out[("gmg", gridop)] = {"x": np.asarray(x), "iters": int(iters),
                                "coarse": coarse,
                                "comm": mg.cycle_comm_volumes,
                                "diagnostics": mg.diagnostics(),
                                "omega": [float(o)
                                          for o, _ in mg.level_params]}
    dA = JP.shard_csr(A, mesh=mesh)
    seen = []
    x, iters = JP.dist_minres(dA, gmg_rhs(), rtol=1e-8,
                              callback=lambda xk: seen.append(xk.shape))
    out["minres"] = {"x": np.asarray(x), "iters": int(iters), "seen": seen}

    C = jsparse.csr_array(compressed_source()).compress()
    xc = jnp.asarray(np.linspace(-1.0, 1.0, 96), jnp.float32)
    for layout in LAYOUTS:
        m = (JP.make_grid_mesh(devs[:WORLD], shape=(2, 4))
             if layout == "2d-block" else mesh)
        dC = JP.shard_csr(C, mesh=m, layout=layout)
        xs = shard_vector(xc, dC.mesh, dC.rows_padded, layout=dC.layout)
        out[("compressed", layout)] = {
            "y": np.asarray(JP.dist_spmv(dC, xs))[:96],
            "cols": str(np.dtype(dC.cols.dtype))}

    # reshard of a matrix, every layout pair on the 8-device row mesh.
    A = jsparse.csr_array(tridiag().astype(np.float32))
    x = x_f32(96)
    for src in LAYOUTS:
        for dst in LAYOUTS:
            dA = JP.shard_csr(A, mesh=mesh, layout=src)
            B = JP.reshard(dA, layout=dst)
            S = B.to_csr().toscipy()
            xs = shard_vector(x, B.mesh, B.rows_padded, layout=B.layout)
            out[("pair", src, dst)] = {
                "same_object": B is dA, "layout": B.layout, "grid": B.grid,
                "csr": (S.indptr, S.indices, S.data),
                "y": np.asarray(JP.dist_spmv(B, xs))[:96]}

    # reshard_vector onto the rotated mesh: its counters and plan.
    rot = Mesh(np.asarray(list(devs[1:WORLD]) + [devs[0]]), ("rows",))
    n = 64 * WORLD
    v = shard_vector(np.ones(n, np.float32), mesh, n)
    c0 = jobs.counters.snapshot("comm.")
    JP.reshard_vector(v, rot)
    c1 = jobs.counters.snapshot("comm.")
    out["vector"] = {
        "counters": {k: c1[k] - c0.get(k, 0) for k in c1
                     if c1[k] != c0.get(k, 0)},
        "plan_identity": JP.chunk_permute_plan(mesh, mesh),
        "plan_rot": JP.chunk_permute_plan(mesh, rot)}
    return out


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("gridop", ["injection", "linear"])
def test_dist_gmg_cg(port, jax_side, gridop):
    """DistGMG-preconditioned dist_cg: the JAX package's iteration
    count, x within 1e-6 of its, every coarse operator bit for bit, the
    same V-cycle comm prediction; and the solve is right (f64 residual
    1e-9 of ``|b|``, as the JAX package's test asks 1e-10 x 10)."""
    p, j = port[("gmg", gridop)], jax_side[("gmg", gridop)]
    assert p["iters"] == j["iters"]
    err = np.linalg.norm(p["x"] - j["x"]) / np.linalg.norm(j["x"])
    assert err <= 1e-6, err
    assert len(p["coarse"]) == len(j["coarse"]) == 2
    for a, b in zip(p["coarse"], j["coarse"]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert p["comm"] == j["comm"]
    assert p["diagnostics"] == j["diagnostics"]
    b = gmg_rhs()
    res = np.linalg.norm(poisson(GMG_N) @ p["x"] - b)
    assert res <= 1e-10 * np.linalg.norm(b) * 10


@pytest.mark.parametrize("gridop", ["injection", "linear"])
def test_dist_gmg_omega_per_level(port, jax_side, gridop):
    """Each level's smoother weight ``omega / rho``, rho the power
    iteration's estimate of ``rho(A D^-1)``, within 1e-12 of the JAX
    package's (its norm and Rayleigh quotient sum in another order)."""
    p, j = port[("gmg", gridop)]["omega"], jax_side[("gmg", gridop)]["omega"]
    assert len(p) == len(j) == 3
    np.testing.assert_allclose(p, j, rtol=1e-12)


def test_dist_minres_callback(port, jax_side):
    """``dist_minres(callback=...)`` runs scipy's host loop in both
    packages: equal iteration and callback counts, each iterate of the
    true row count, x within 1e-10 of the JAX package's."""
    p, j = port["minres"], jax_side["minres"]
    assert p["iters"] == j["iters"] == len(p["seen"]) == len(j["seen"])
    assert p["seen"] == j["seen"]
    assert all(s == (GMG_N * GMG_N,) for s in p["seen"])
    err = np.linalg.norm(p["x"] - j["x"]) / np.linalg.norm(j["x"])
    assert err <= 1e-10, err


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compressed_dist_spmv(port, jax_side, layout):
    """A ``compress()``ed matrix sharded ``layout``: ``dist_spmv`` of an
    f32 x is f32, within 1e-5 of the local ``C @ x`` and of the JAX
    package's, and the 2-d blocks carry int16 columns and bf16 data."""
    p, j = port[("compressed", layout)], jax_side[("compressed", layout)]
    assert p["dtype"] == "torch.float32"
    np.testing.assert_allclose(p["y"], p["y_local"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p["y"], j["y"], rtol=1e-5, atol=1e-6)
    assert p["data"] == "torch.bfloat16"
    if layout == "2d-block":
        assert p["cols"] == "torch.int16" and j["cols"] == "int16"


@pytest.mark.parametrize("src", LAYOUTS)
@pytest.mark.parametrize("dst", LAYOUTS)
def test_matrix_reshard_pair(port, jax_side, src, dst):
    """``reshard(A, layout=dst)`` is a fresh ``shard_csr`` of the kept
    source on the destination (same plan fingerprint), ``A`` itself for
    ``dst == src``; back on the source mesh it takes the source's
    fingerprint; every SpMV within 1e-5 of the local product.  Against
    the JAX package's ``reshard`` of the same pair: the same layout,
    grid and fast path, the gathered entries bit for bit, and its
    ``dist_spmv`` within 1e-5 (and 1e-6 absolute: f32, summed in
    another order)."""
    r = port["reshard"][("pair", src, dst)]
    j = jax_side[("pair", src, dst)]
    assert r["same_object"] == (src == dst)
    assert r["layout"] == dst
    assert r["grid"] == (None if dst == "1d-row" else
                         {"1d-col": (1, WORLD), "2d-block": (2, 4)}[dst])
    assert r["fp_fresh"] and r["fp_back"]
    assert max(r["err"]) <= 1e-5 * 6.0, r["err"]
    assert (r["same_object"], r["layout"], r["grid"]) == (
        j["same_object"], j["layout"], j["grid"])
    for u, v in zip(r["csr"], j["csr"]):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_allclose(r["y"], j["y"], rtol=1e-5, atol=1e-6)


def test_matrix_reshard_errors(port):
    """The typed errors: no kept source (the sibling with its source
    still takes the fast path), a destination over fewer ranks (naming
    both fingerprints), a destination that permutes the ranks."""
    r = port["reshard"]
    err, fp = r["errors"], r["fingerprints"]
    assert "_src_csr" in err["no_source"]
    assert r["sibling_fast_path"]
    assert fp["src"] in err["shrink"] and fp["small"] in err["shrink"]
    assert "survivor mesh" in err["shrink"]
    assert "permutes the ranks" in err["permuted"]
    assert "repartition" in err["vector_shrink"]
    assert fp["src"] in err["vector_shrink"]
    assert fp["small"] in err["vector_shrink"]
    assert f"{WORLD} -> {WORLD - 1}" in err["vector_shrink"]
    assert "same device set" in err["plan_shrink"]


def test_plan_fingerprints_never_alias(port):
    """A layout change gives a new plan fingerprint, a permuted mesh a
    new mesh fingerprint, the no-op reshard the source's."""
    fp = port["reshard"]["fingerprints"]
    assert fp["plan_2d"] != fp["plan_src"]
    assert fp["rot"] != fp["src"]
    assert fp["plan_noop"] == fp["plan_src"]


def test_vector_chunk_permute_roundtrip(port):
    """Onto the rotated placement: each rank holds the chunk its
    coordinate there names; back: bit for bit the original."""
    v = port["reshard"]["vector"]
    n = 64 * WORLD
    L = n // WORLD
    c = v["rot_coord"]
    np.testing.assert_array_equal(v["chunk"], np.arange(c * L, (c + 1) * L))
    np.testing.assert_array_equal(v["back"], v["orig"])
    np.testing.assert_array_equal(v["identity"], v["orig"])


def test_vector_comm_counters(port, jax_side):
    """One permute records ``comm.dist_reshard.ppermute`` once with the
    bytes ``reshard_volumes`` predicts, the JAX package's counters; the
    identity placement records nothing."""
    from legate_sparse_tpu_torch.obs import comm as obs_comm

    v = port["reshard"]["vector"]
    pred = obs_comm.reshard_volumes(moved_chunks=WORLD, chunk_elems=64,
                                    itemsize=4, shards=WORLD)["ppermute"]
    assert v["counters"]["comm.dist_reshard.ppermute_bytes"] == pred
    assert v["counters"]["comm.dist_reshard.ppermute"] == 1
    assert v["counters"]["comm.layout.1d-row.dist_reshard_bytes"] == pred
    assert v["counters"] == jax_side["vector"]["counters"]
    assert v["counters_back"] == v["counters"]
    assert v["counters_identity"] == {}


def test_chunk_permute_plan_pairs(port, jax_side):
    v, j = port["reshard"]["vector"], jax_side["vector"]
    assert v["plan_identity"] == j["plan_identity"]
    assert v["plan_identity"] == (tuple((c, c) for c in range(WORLD)), 0)
    assert v["plan_rot"] == j["plan_rot"]
    assert v["plan_rot"][1] == WORLD
