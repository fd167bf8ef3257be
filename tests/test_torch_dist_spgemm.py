# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``dist_spgemm`` at 8 gloo ranks against the JAX
package's on its 8-device CPU mesh.

One spawn of 8 ranks (``parallel.launch.run_ranks``) runs every case
and sends rank 0's numpy results back, then spawns of 2 and 3 ranks run
the general cases (no window at 2 ranks; a window at 3, where the plan's
floor admits two blocks), held to the 8-rank results.  The ranks run
in a thread while the JAX side runs the same cases in the pytest
process; both sides run one function, ``_cases``, through an adapter
of their package.  This module imports no JAX at its top: the ranks
import it to find their function, and each asserts JAX stays out.

Cases (``tests/test_dist_spgemm.py``'s, f64): random shapes
(64, 64, 64), (96, 40, 56) and (17, 33, 9); the banded ELL layout; the
empty product; the banded product of two exact bands, chained, and the
DIA SpMV of the result; the general product of a holey band (the
window); the rectangular Galerkin ``A @ P`` (a forced all-gather A,
the window) and the triple product ``R @ (A @ P)``; an ELL A times a
padded-CSR B; the dense A that declines the window; and 2-d SUMMA on a
2x4 grid, with the 2-d SpMV of its result.

Compared: the route (``band``, ``window`` or ``all_gather`` and the
plan, ``2d_panel``), the ``op.*`` and ``dist_spgemm.realization.*``
counters of each product, the ``dist_spgemm.realization`` event's
prediction of the JAX package's traffic, and the product gathered by
``to_csr()``: structure and values bit for bit (the banded
product runs the JAX loop's multiply-adds in its order; the ESC sums
each output entry's products in expansion order in both packages, a
sequential sum on the CPU).  Against scipy: 1e-12 of ``|A| |B|``.
The SpMVs of the products: bit for bit on the DIA route, 1e-13 of
``|C| |x|`` on the 2-d one (another summation order).  The port's
``comm.*`` counters of each product hold what its ranks sent: every
all-gather and P2P send, metered in the ranks and summed over them.
"""

import numpy as np
import pytest
import scipy.sparse as sp

WORLD = 8
RANK_TIMEOUT = 240.0
SHAPES = ((64, 64, 64), (96, 40, 56), (17, 33, 9))
CASES = tuple(f"random-{m}x{k}x{n}" for m, k, n in SHAPES) + (
    "banded-ell", "empty", "band-chain", "window-holey",
    "window-galerkin", "galerkin-triple", "mixed-layouts",
    "dense-fallback", "summa-2x4")
# Cases the spawns of 2 and 3 ranks rerun.
SMALL_WORLDS = (2, 3)
SMALL_CASES = ("random-64x64x64", "window-holey", "window-galerkin",
               "galerkin-triple")


def _random_csr(rng, m, n, density=0.08):
    M = sp.random(m, n, density=density, random_state=rng, format="csr")
    M.sum_duplicates()
    return M


def _tridiag(n, main=2.0):
    return sp.diags([-1.0, main, -1.0], [-1, 0, 1], shape=(n, n),
                    format="csr")


def _interp(nf, nc, halves=True):
    rows, cols, vals = [], [], []
    for i in range(nf):
        if i // 2 < nc:
            rows.append(i)
            cols.append(i // 2)
            vals.append(0.5 + 0.5 * (i % 2) if halves else 1.0)
    return sp.csr_matrix((vals, (rows, cols)), shape=(nf, nc))


def _holey(n, period):
    d0 = np.where(np.arange(n) % period == 0, 0.0, 2.0)
    return sp.diags([d0, np.ones(n - 1)], [0, 1], shape=(n, n), format="csr")


def _cases(api, names):
    """Every case of ``names`` through ``api`` (one package's adapter):
    each product's record (``api.product``), and the SpMV of the
    products that feed one."""
    out = {}
    for name in names:
        api.reset()
        rec = {}
        if name.startswith("random-"):
            m, k, n = (int(v) for v in name[7:].split("x"))
            rng = np.random.RandomState(7 + SHAPES.index((m, k, n)))
            A, B = _random_csr(rng, m, k), _random_csr(rng, k, n)
            rec["C"] = api.product(api.shard(A), api.shard(B))
        elif name == "banded-ell":
            dA = api.shard(_tridiag(128))
            rec["C"] = api.product(dA, dA)
        elif name == "empty":
            rec["C"] = api.product(api.shard(sp.csr_matrix((24, 16))),
                                   api.shard(sp.csr_matrix((16, 24))))
        elif name == "band-chain":
            n = 256
            dA = [np.random.default_rng(i).normal(size=n - abs(o))
                  for i, o in enumerate([-1, 0, 1])]
            dB = [np.random.default_rng(7 + i).normal(size=n - abs(o))
                  for i, o in enumerate([-2, 0, 2])]
            A = api.shard(sp.diags(dA, [-1, 0, 1], shape=(n, n),
                                   format="csr"))
            B = api.shard(sp.diags(dB, [-2, 0, 2], shape=(n, n),
                                   format="csr"))
            rec["C"], C = api.product(A, B, keep=True)
            rec["C2"] = api.product(C, C)
            rec["y"] = api.spmv(C, np.random.default_rng(3).normal(size=n))
        elif name == "window-holey":
            dA = api.shard(_holey(128, 3))
            rec["C"] = api.product(dA, dA)
        elif name == "window-galerkin":
            dA = api.shard(_tridiag(96), force_all_gather=True)
            rec["C"] = api.product(dA, api.shard(_interp(96, 48, False)))
        elif name == "galerkin-triple":
            P = _interp(64, 32)
            dA = api.shard(_tridiag(64))
            dP, dR = api.shard(P), api.shard((P.T / 2.0).tocsr())
            rec["AP"], AP = api.product(dA, dP, keep=True)
            rec["C"] = api.product(dR, AP)
        elif name == "mixed-layouts":
            rng = np.random.RandomState(3)
            heavy = sp.lil_matrix((96, 96))
            heavy[0, :] = 1.0
            B = (_random_csr(rng, 96, 96, 0.02) + heavy.tocsr()).tocsr()
            rec["C"] = api.product(api.shard(sp.diags(
                [1.0, 3.0, 1.0], [-1, 0, 1], shape=(96, 96), format="csr")),
                api.shard(B))
        elif name == "dense-fallback":
            rng = np.random.RandomState(11)
            rec["C"] = api.product(api.shard(_random_csr(rng, 64, 64, 0.3)),
                                   api.shard(_random_csr(rng, 64, 64, 0.1)))
        elif name == "summa-2x4":
            rng = np.random.RandomState(5)
            A, B = _random_csr(rng, 64, 48, 0.1), _random_csr(rng, 48, 40,
                                                              0.1)
            rec["C"], C = api.product(api.shard(A, grid=True),
                                      api.shard(B, grid=True), keep=True)
            rec["y"] = api.spmv(C, np.random.default_rng(4).normal(size=40))
        out[name] = rec
    return out


def operands(name):
    """The scipy operands of each product of a case, in order, for the
    checks against scipy (the same draws as ``_cases``)."""
    class Host:
        def __init__(self):
            self.products = []

        def reset(self):
            pass

        def shard(self, S, **kw):
            return S

        def product(self, A, B, keep=False):
            self.products.append((A, B))
            return (None, A @ B) if keep else None

        def spmv(self, C, x):
            return (C, x)

    host = Host()
    rec = _cases(host, [name])[name]
    return host.products, rec.get("y")


# ------------------------------------------------------------- the ranks --

class _PortApi:
    def __init__(self):
        import importlib

        import legate_sparse_tpu_torch as tsparse
        from legate_sparse_tpu_torch import obs, parallel as P

        self.sparse, self.obs, self.P = tsparse, obs, P
        self.mod = importlib.import_module(
            "legate_sparse_tpu_torch.parallel.dist_spgemm")
        self.meshes = {False: P.make_row_mesh()}

    def reset(self):
        self.mod.reset_window_declines()

    def shard(self, S, grid=False, **kw):
        A = self.sparse.csr_array(sp.csr_matrix(S), device="cpu")
        if grid:
            kw["layout"] = "2d-block"
            self.meshes[True] = self.P.make_grid_mesh(2, 4)
        return self.P.shard_csr(A, mesh=self.meshes[grid], **kw)

    def _counters(self):
        return {k: v for k, v in self.obs.counters.snapshot().items()
                if k.startswith(("op.dist_spgemm", "comm.",
                                 "dist_spgemm.realization."))}

    def product(self, A, B, keep=False):
        """The product's record, with ``wire``: the bytes of every
        all-gather (``(R - 1)`` times the block, as ``obs.comm`` counts
        a group's total) and P2P send this rank made in the product,
        summed over the ranks, and the most all-gathers and P2P rounds
        any rank made."""
        import torch
        import torch.distributed as dist

        meter = [0, 0, 0]
        real_ag, real_p2p = self.mod._all_gather, dist.batch_isend_irecv

        def all_gather(x, group):
            nbytes = ((dist.get_world_size(group) - 1) * x.numel()
                      * x.element_size())
            if nbytes:
                meter[0] += nbytes
                meter[1] += 1
            return real_ag(x, group)

        def batch_isend_irecv(ops):
            meter[0] += sum(op.tensor.numel() * op.tensor.element_size()
                            for op in ops if op.op is dist.isend)
            meter[2] += 1
            return real_p2p(ops)

        self.mod._all_gather = all_gather
        dist.batch_isend_irecv = batch_isend_irecv
        try:
            rec, C = _product_record(self, A, B)
        finally:
            self.mod._all_gather, dist.batch_isend_irecv = real_ag, real_p2p
        total = torch.tensor(meter[:1], dtype=torch.int64)
        calls = torch.tensor(meter[1:], dtype=torch.int64)
        dist.all_reduce(total)
        dist.all_reduce(calls, op=dist.ReduceOp.MAX)
        rec["wire"] = {"bytes": int(total), "all_gather": int(calls[0]),
                       "p2p": int(calls[1])}
        return (rec, C) if keep else rec

    def spmv(self, C, x):
        import torch

        from legate_sparse_tpu_torch.parallel import dist_csr as D

        xs = D.shard_vector(torch.from_numpy(x), C.mesh,
                            C.cols_padded if C.grid else C.rows_padded,
                            layout=C.layout)
        y = self.P.dist_spmv(C, xs).full_tensor().numpy()[:C.shape[0]]
        return {"y": y, "path": C.spmv_path}


def _product_record(api, A, B):
    """``(record, C)`` of ``C = A @ B`` through either package's
    ``api``: the product by ``to_csr()``, its counters, its realization
    and the event's prediction of the JAX package's traffic."""
    c0 = api._counters()
    api.obs.trace.reset()
    C = api.P.dist_spgemm(A, B)
    counters = {k: v - c0.get(k, 0) for k, v in api._counters().items()
                if v != c0.get(k, 0)}
    events = [r["attrs"] for r in api.obs.records()
              if r.get("name") == "dist_spgemm.realization"]
    S = C.to_csr().toscipy()
    real, plan = api.mod.last_b_realization()
    rec = {"csr": (S.indptr, S.indices, S.data), "shape": S.shape,
           "counters": counters, "realization": real, "plan": plan,
           "dia": C.dia_data is not None, "halo": C.halo,
           "rps": C.rows_per_shard, "grid": C.grid,
           "nnz_hint": C.nnz_hint,
           "predicted": {k: v for k, v in events[-1].items()
                         if k.startswith("predicted_")}}
    api.mod.LAST_B_REALIZATION, api.mod.LAST_B_PLAN = "", ()
    return rec, C


def _ranks(rank, world, names):
    from legate_sparse_tpu_torch import obs, runtime

    runtime.set_device("cpu")
    obs.enable()
    out = _cases(_PortApi(), names)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def port_launch():
    """The launches of 8, then 2 and 3 ranks, in a thread that starts
    before the JAX side runs; collected after it."""
    from concurrent.futures import ThreadPoolExecutor

    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    with ThreadPoolExecutor(1) as pool:
        futures = {WORLD: pool.submit(run_ranks, _ranks, WORLD,
                                      backend="gloo", args=(CASES,),
                                      timeout=RANK_TIMEOUT, threads=1)}
        for world in SMALL_WORLDS:
            futures[world] = pool.submit(
                run_ranks, _ranks, world, backend="gloo",
                args=(SMALL_CASES,), timeout=RANK_TIMEOUT / 2, threads=1)
        yield futures


@pytest.fixture(scope="module")
def port(port_launch, jax_side):
    return port_launch[WORLD].result()[0]


@pytest.fixture(scope="module")
def port_small(port_launch, jax_side):
    return {world: port_launch[world].result()[0] for world in SMALL_WORLDS}


# ---------------------------------------------------------- the JAX side --

class _JaxApi:
    def __init__(self, devs):
        import importlib

        import legate_sparse_tpu as jsparse
        from legate_sparse_tpu import obs
        from legate_sparse_tpu import parallel as JP

        self.sparse, self.obs, self.P = jsparse, obs, JP
        self.mod = importlib.import_module(
            "legate_sparse_tpu.parallel.dist_spgemm")
        self.meshes = {False: JP.make_row_mesh(devs),
                       True: JP.make_grid_mesh(devs, shape=(2, 4))}

    reset = _PortApi.reset

    def shard(self, S, grid=False, **kw):
        A = self.sparse.csr_array(sp.csr_matrix(S))
        if grid:
            kw["layout"] = "2d-block"
        return self.P.shard_csr(A, mesh=self.meshes[grid], **kw)

    def _counters(self):
        return {k: v for k, v in self.obs.snapshot().items()
                if k.startswith(("op.dist_spgemm", "comm.",
                                 "dist_spgemm.realization."))}

    def product(self, A, B, keep=False):
        rec, C = _product_record(self, A, B)
        return (rec, C) if keep else rec

    def spmv(self, C, x):
        import jax.numpy as jnp

        from legate_sparse_tpu.parallel.dist_csr import shard_vector

        xs = shard_vector(jnp.asarray(x), C.mesh,
                          C.cols_padded if C.grid else C.rows_padded,
                          layout=C.layout)
        self.obs.trace.reset()
        y = np.asarray(self.P.dist_spmv(C, xs))[:C.shape[0]]
        spans = [r for r in self.obs.records() if r.get("name") == "dist_spmv"]
        return {"y": y, "path": spans[-1]["attrs"]["path"]}


@pytest.fixture(scope="module")
def jax_side():
    import jax

    devs = jax.devices("cpu")
    if len(devs) < WORLD:
        pytest.skip("needs 8 virtual devices")
    api = _JaxApi(devs[:WORLD])
    api.obs.enable()
    try:
        return _cases(api, CASES)
    finally:
        api.obs.disable()
        api.obs.reset_all()


# ----------------------------------------------------------------- tests --

def _same_csr(a, b, what):
    for u, v, part in zip(a, b, ("indptr", "indices", "data")):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                      f"{what}: {part}")


# The products of a case, in the order it runs them.
CASE_KEYS = {"band-chain": ("C", "C2"), "galerkin-triple": ("AP", "C")}


def _products(name):
    return CASE_KEYS.get(name, ("C",))


@pytest.mark.parametrize("name", CASES)
def test_product_bitwise(port, jax_side, name):
    """Each product gathered by ``to_csr()``: structure and values bit
    for bit with the JAX package's."""
    for key in _products(name):
        p, j = port[name][key], jax_side[name][key]
        assert p["shape"] == j["shape"]
        _same_csr(p["csr"], j["csr"], f"{name}/{key}")


def _not_comm(counters):
    return {k: v for k, v in counters.items() if not k.startswith("comm.")}


def _assert_wire(rec, what):
    """The ``comm.*`` counters of a product hold the bytes its ranks
    sent, one call an all-gather and one a P2P round."""
    c, w = rec["counters"], rec["wire"]
    assert w["bytes"] > 0, what
    kinds = {"all_gather": 0, "ppermute": 0}
    for k, v in c.items():
        kind = k.rsplit(".", 1)[-1]
        if k.startswith("comm.dist_spgemm") and kind in kinds:
            kinds[kind] += v
    assert c.get("comm.total_bytes", 0) == w["bytes"], what
    assert (kinds["all_gather"], kinds["ppermute"]) == (
        w["all_gather"], w["p2p"]), what


@pytest.mark.parametrize("name", CASES)
def test_route_and_counters(port, jax_side, name):
    """The realization and its plan, the result's layout, the
    ``op.dist_spgemm`` and ``dist_spgemm.realization.*`` counters of
    each product, and the ``dist_spgemm.realization`` event's predicted
    bytes (the JAX package's formulas for its own three phases) equal
    the JAX package's; the JAX package's ``comm.*`` counters hold that
    prediction."""
    for key in _products(name):
        p, j = port[name][key], jax_side[name][key]
        assert (p["realization"], p["plan"]) == (j["realization"],
                                                 tuple(j["plan"]))
        assert (p["dia"], p["halo"], p["rps"]) == (j["dia"], j["halo"],
                                                   j["rps"])
        assert p["grid"] == (tuple(j["grid"]) if j["grid"] else None)
        assert _not_comm(p["counters"]) == _not_comm(j["counters"]), (
            f"{name}/{key}")
        assert p["predicted"] == j["predicted"], f"{name}/{key}"
        assert sum(v for k, v in j["counters"].items()
                   if k.startswith("comm.dist_spgemm.")
                   and k.endswith("_bytes") and ".window_probe." not in k
                   ) == j["predicted"]["predicted_bytes"], f"{name}/{key}"


@pytest.mark.parametrize("name", CASES)
def test_comm_ledger_is_the_wire(port, name):
    """Each product's ``comm.*`` counters at 8 ranks are what its ranks
    sent (metered in the ranks; the window probe included)."""
    for key in _products(name):
        _assert_wire(port[name][key], f"{name}/{key}")


@pytest.mark.parametrize("name", CASES)
def test_against_scipy(port, name):
    """Each product against scipy's f64 product of the same operands,
    within 1e-12 of ``|A| |B|``; ``nnz_hint`` is its stored count."""
    products, _ = operands(name)
    keys = _products(name)
    assert len(keys) == len(products)
    for key, (A, B) in zip(keys, products):
        p = port[name][key]
        got = sp.csr_matrix(p["csr"][::-1], shape=p["shape"])
        ref = (A @ B).tocsr()
        mag = (abs(A) @ abs(B)).toarray()
        assert np.all(np.abs(got.toarray() - ref.toarray())
                      <= 1e-12 * mag + 1e-300), f"{name}/{key}"
        assert p["nnz_hint"] == got.nnz


@pytest.mark.parametrize("name", ["band-chain", "summa-2x4"])
def test_spmv_of_product(port, jax_side, name):
    """The banded product through the DIA route (bit for bit), the 2-d
    product through the 2-d SpMV (1e-13 of ``|C| |x|``)."""
    p, j = port[name]["y"], jax_side[name]["y"]
    port_label = {"dia-pallas": "dia-kernel", "dia-xla": "dia-torch"}
    assert p["path"] == port_label.get(j["path"], j["path"])
    if name == "band-chain":
        np.testing.assert_array_equal(p["y"], j["y"])
        return
    _, (C, x) = operands(name)
    mag = abs(C) @ np.abs(x)
    assert np.all(np.abs(p["y"] - j["y"]) <= 1e-13 * mag + 1e-300)


@pytest.mark.parametrize("world", SMALL_WORLDS)
@pytest.mark.parametrize("name", SMALL_CASES)
def test_fewer_ranks(port, port_small, world, name):
    """At 2 ranks the plan takes the all-gather without a probe, at 3
    the window where its floor admits it; the ``comm.*`` counters are
    what the ranks sent; the products are bit for bit the 8-rank ones (each output entry sums its products in the same
    order whatever the rank count)."""
    for key in _products(name):
        p, p8 = port_small[world][name][key], port[name][key]
        _same_csr(p["csr"], p8["csr"], f"{name}/{key} at {world} ranks")
        _assert_wire(p, f"{name}/{key} at {world} ranks")
        if world == 2:
            assert p["realization"] == "all_gather" and p["plan"] == ()
            assert "dist_spgemm.window_probe" not in str(p["counters"])
    if world == 3 and name == "window-holey":
        assert port_small[3][name]["C"]["realization"] == "window"
