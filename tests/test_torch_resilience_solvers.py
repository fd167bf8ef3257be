# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The resilience layer's solver and distribution sites in the port,
against the JAX package's (the tests of ``tests/test_resilience.py``
that ``test_torch_resilience_core.py`` leaves: the solver drills, the
distributed sites, deadlines and health), and the coverage check that
stands in for ``tools/check_fault_sites.py``.

Single-device drills run in the pytest process on both packages (the
port on ``device="cpu"``) with the same numpy operands; each package's
retried solve is bit for bit its own clean solve, with the JAX
package's exact ``resil.*`` accounting, and the two packages' iterates
agree within 1e-5 (f32).  The distributed drills run once on each side:
the JAX package on its 8-device CPU mesh, the port on 8 gloo ranks (one
spawn; this module imports no JAX at its top).  There the solvers' loop
products bypass the ``dist.spmv`` site, as the JAX package's traced
loop does, and ``dist_cg``'s first residual goes through it, so a
fail-twice ``dist.spmv`` fault inside ``dist_cg`` is retried twice
there and ``dist.cg`` not at all, in both packages.
"""

import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

WORLD = 8
RANK_TIMEOUT = 240.0
_KNOBS = ("resil", "resil_retries", "resil_backoff_ms", "resil_backoff_mult",
          "resil_backoff_max_ms", "resil_retry_budget", "resil_breaker_k",
          "resil_breaker_cooldown_ms", "resil_health",
          "resil_stagnation_cycles", "resil_divergence_mult")
PKG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "legate_sparse_tpu_torch")


def tridiag(n, dtype=np.float32):
    return sp.diags([np.full(n, 4.0, dtype), np.full(n - 1, -1.0, dtype),
                     np.full(n - 1, -1.0, dtype)], [0, 1, -1], format="csr",
                    dtype=dtype)


class _Pkg:
    def __init__(self, name):
        self.name = name
        if name == "jax":
            import legate_sparse_tpu as sparse
            from legate_sparse_tpu import obs, resilience
            from legate_sparse_tpu.settings import settings
        else:
            import legate_sparse_tpu_torch as sparse
            from legate_sparse_tpu_torch import obs, resilience
            from legate_sparse_tpu_torch.settings import settings
        self.sparse, self.obs, self.resil = sparse, obs, resilience
        self.settings = settings

    def csr(self, S):
        if self.name == "jax":
            return self.sparse.csr_array(S)
        return self.sparse.csr_array(S, device="cpu")

    def np(self, x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    from legate_sparse_tpu_torch import runtime

    runtime.set_device("cpu")
    p = _Pkg(request.param)
    saved = {k: getattr(p.settings, k) for k in _KNOBS}
    p.settings.resil = True
    p.settings.resil_backoff_ms = 0.0
    p.settings.resil_breaker_cooldown_ms = 40.0
    p.resil.reset()
    p.obs.counters.reset("resil.")
    yield p
    for k, v in saved.items():
        setattr(p.settings, k, v)
    p.resil.reset()
    runtime.set_device(None)


def drill(p, site, run_clean, run=None):
    """Clean run, arm fail-twice, rerun: two retries and two fires at
    ``site``, the result bit for bit the clean one."""
    run = run or run_clean
    clean = p.np(run_clean())
    r0 = p.obs.counters.get(f"resil.retry.{site}")
    f0 = p.obs.counters.get(f"resil.fault.{site}.injected")
    p.resil.inject(site, kind="error", count=2)
    recovered = p.np(run())
    assert p.obs.counters.get(f"resil.retry.{site}") - r0 == 2
    assert p.obs.counters.get(f"resil.fault.{site}.injected") - f0 == 2
    assert p.resil.faults.fired(site) == 2
    np.testing.assert_array_equal(clean, recovered)
    p.resil.faults.clear()
    return recovered


_RESULTS = {}


def _hold_equal(key, p, value, rtol=1e-5):
    """Keep each package's result under ``key``; when both are in, hold
    them within ``rtol`` (f32)."""
    got = _RESULTS.setdefault(key, {})
    got[p.name] = value
    if len(got) == 2:
        np.testing.assert_allclose(got["torch"], got["jax"], rtol=rtol,
                                   atol=rtol)


# ---------------------------------------------------------- solver drills --

def test_drill_solver_gmres(pkg):
    A = pkg.csr(tridiag(128))
    b = np.ones(128, np.float32)
    x = drill(pkg, "solver.gmres.conv",
              lambda: pkg.sparse.linalg.gmres(A, b, restart=10,
                                              maxiter=100)[0])
    _hold_equal("gmres", pkg, x)


def test_drill_solver_cg_chunked(pkg):
    """Under an active deadline scope ``cg`` runs in stretches, each the
    ``solver.cg.conv`` site; a generous budget lets only the fault
    fire."""
    A = pkg.csr(tridiag(256))
    b = np.ones(256, np.float32)

    def run():
        with pkg.resil.deadline.scope(60_000.0):
            return pkg.sparse.linalg.cg(A, b, maxiter=100)[0]

    x = drill(pkg, "solver.cg.conv", run)
    _hold_equal("cg", pkg, x)


@pytest.mark.parametrize("scope", ["deadline", "checkpoint", "health"])
def test_chunked_cg_bit_identical_to_plain(pkg, scope):
    """The resilient stretches are bit for bit the plain loop: same
    iterate, same count; in the port the same host syncs too."""
    A = pkg.csr(tridiag(256))
    b = np.ones(256, np.float32)
    pkg.settings.resil = False
    c0 = pkg.obs.counters.snapshot()
    x_plain, it_plain = pkg.sparse.linalg.cg(A, b, maxiter=100)
    c1 = pkg.obs.counters.snapshot()
    pkg.settings.resil = True
    if scope == "deadline":
        ctx = pkg.resil.deadline.scope(60_000.0)
    elif scope == "checkpoint":
        ctx = pkg.resil.checkpoint.scope("t", every=7)
    else:
        pkg.settings.resil_health = True
        ctx = pkg.resil.deadline.scope(60_000.0)
    with ctx:
        x_res, it_res = pkg.sparse.linalg.cg(A, b, maxiter=100)
    c2 = pkg.obs.counters.snapshot()
    assert int(it_plain) == int(it_res)
    np.testing.assert_array_equal(pkg.np(x_plain), pkg.np(x_res))
    if pkg.name == "torch":
        key = "transfer.host_sync.cg_conv"
        assert c2[key] - c1[key] == c1[key] - c0.get(key, 0)
    _hold_equal(("chunked", scope), pkg, pkg.np(x_res))


def test_solver_deadline_typed_outcomes(pkg):
    A = pkg.csr(tridiag(512))
    b = np.ones(512, np.float32)
    with pytest.raises(pkg.resil.DeadlineExceeded) as ei:
        with pkg.resil.deadline.scope(0.0):
            pkg.sparse.linalg.cg(A, b, maxiter=1000)
    assert ei.value.site == "solver.cg.conv"
    assert ei.value.iterations == 0             # before any stretch
    with pytest.raises(pkg.resil.DeadlineExceeded) as ei:
        with pkg.resil.deadline.scope(0.0):
            pkg.sparse.linalg.gmres(A, b, restart=10, maxiter=1000)
    assert ei.value.site == "solver.gmres.conv"
    assert pkg.obs.counters.get("resil.deadline.solver") == 2
    assert pkg.obs.counters.get("resil.deadline.solver.cg.conv") == 1


def test_injected_latency_expires_solver_deadline(pkg):
    """Injected per-cycle latency pushes the solve past its budget: a
    typed outcome with the partial iterate, not a hang."""
    A = pkg.csr(tridiag(512))
    b = np.ones(512, np.float32)
    pkg.resil.inject("solver.gmres.conv", kind="latency", latency_ms=40.0,
                     count=100)
    with pytest.raises(pkg.resil.DeadlineExceeded) as ei:
        with pkg.resil.deadline.scope(30.0):
            pkg.sparse.linalg.gmres(A, b, restart=5, maxiter=10_000,
                                    rtol=1e-12)
    assert ei.value.iterations >= 0
    assert ei.value.partial is not None
    pkg.resil.faults.clear()


# ------------------------------------------------------------------ health --

def test_health_nonfinite_surfaced_gmres(pkg):
    pkg.settings.resil_health = True
    A = pkg.csr(tridiag(128))
    b = np.ones(128, np.float32)
    pkg.resil.inject("solver.gmres.conv", kind="nonfinite", count=1)
    with pytest.raises(pkg.resil.SolverHealthError) as ei:
        pkg.sparse.linalg.gmres(A, b, restart=10, maxiter=100)
    rep = ei.value.report
    assert rep.cause == "non_finite"
    assert rep.site == "solver.gmres.conv"
    assert rep.iterations == 10
    assert np.isnan(rep.residual)
    assert ei.value.partial is not None
    assert pkg.obs.counters.get(
        "resil.health.solver.gmres.conv.non_finite") == 1
    assert pkg.obs.counters.get("resil.health.non_finite") == 1
    pkg.resil.faults.clear()


def test_health_nonfinite_surfaced_cg(pkg):
    pkg.settings.resil_health = True
    A = pkg.csr(tridiag(256))
    b = np.ones(256, np.float32)
    pkg.resil.inject("solver.cg.conv", kind="nonfinite", count=1)
    with pytest.raises(pkg.resil.SolverHealthError) as ei:
        pkg.sparse.linalg.cg(A, b, maxiter=100)
    assert ei.value.report.cause == "non_finite"
    assert ei.value.report.site == "solver.cg.conv"
    assert ei.value.report.iterations == 25
    assert ei.value.partial is not None
    pkg.resil.faults.clear()


def test_health_off_keeps_old_semantics(pkg):
    """Without the health opt-in a poisoned residual does not raise."""
    assert pkg.settings.resil_health is False
    A = pkg.csr(tridiag(128))
    b = np.ones(128, np.float32)
    pkg.resil.inject("solver.gmres.conv", kind="nonfinite", count=1)
    x, it = pkg.sparse.linalg.gmres(A, b, restart=10, maxiter=50)
    assert int(it) >= 0
    pkg.resil.faults.clear()
    _hold_equal("health_off", pkg, [int(it)], rtol=0)


def test_health_stagnation_detected(pkg):
    """GMRES(1) on a skew rotation stagnates (r ⟂ Ar): the stagnation
    monitor calls it instead of burning maxiter."""
    pkg.settings.resil_health = True
    pkg.settings.resil_stagnation_cycles = 3
    A = pkg.csr(sp.csr_matrix(np.array([[0.0, 1.0], [-1.0, 0.0]],
                                       dtype=np.float32)))
    b = np.array([1.0, 0.0], np.float32)
    with pytest.raises(pkg.resil.SolverHealthError) as ei:
        pkg.sparse.linalg.gmres(A, b, restart=1, maxiter=500)
    assert ei.value.report.cause == "stagnation"
    _hold_equal("stagnation", pkg, [ei.value.report.iterations], rtol=0)


def test_health_divergence_detected(pkg):
    """A residual past ``resil_divergence_mult`` times the first one is
    the ``divergence`` verdict: a tiny multiplier makes the first
    observation, at the first fetch, diverge."""
    pkg.settings.resil_health = True
    pkg.settings.resil_divergence_mult = 1e-30
    A = pkg.csr(tridiag(256))
    with pytest.raises(pkg.resil.SolverHealthError) as ei:
        with pkg.resil.deadline.scope(60_000.0):
            pkg.sparse.linalg.cg(A, np.ones(256, np.float32), rtol=0.0,
                                 maxiter=100)
    assert ei.value.report.cause == "divergence"
    assert ei.value.report.iterations == 25
    assert pkg.obs.counters.get("resil.health.divergence") == 1


# ------------------------------------------------------ distributed drills --

def _ranks(rank, world):
    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import obs, parallel as P, resilience
    from legate_sparse_tpu_torch import runtime
    from legate_sparse_tpu_torch.parallel.dist_csr import shard_vector
    from legate_sparse_tpu_torch.settings import settings

    runtime.set_device("cpu")
    settings.resil = True
    settings.resil_backoff_ms = 0.0
    resilience.reset()
    out = {}
    dA = P.shard_csr(tsparse.csr_array(tridiag(256), device="cpu"))
    xv = shard_vector(torch.ones(256), dA.mesh, dA.rows_padded)
    b = np.ones(256, np.float32)

    def counts(site):
        return (obs.counters.get(f"resil.retry.{site}"),
                obs.counters.get(f"resil.fault.{site}.injected"))

    clean = P.dist_spmv(dA, xv).full_tensor().numpy()
    c0 = counts("dist.spmv")
    resilience.inject("dist.spmv", kind="error", count=2)
    y = P.dist_spmv(dA, xv).full_tensor().numpy()
    c1 = counts("dist.spmv")
    out["spmv"] = {"retries": c1[0] - c0[0], "injected": c1[1] - c0[1],
                   "same": bool(np.array_equal(clean, y)), "y": y}
    resilience.reset()

    x0, it0 = P.dist_cg(dA, b, maxiter=100)
    x0 = x0.full_tensor().numpy()
    c0 = counts("dist.cg")
    resilience.inject("dist.cg", kind="error", count=1)
    x1, it1 = P.dist_cg(dA, b, maxiter=100)
    c1 = counts("dist.cg")
    out["cg"] = {"retries": c1[0] - c0[0], "iters": (int(it0), int(it1)),
                 "same": bool(np.array_equal(x0, x1.full_tensor().numpy())),
                 "x": x0}
    resilience.reset()

    C0 = P.dist_spgemm(dA, dA).to_csr()
    c0 = counts("dist.spgemm")
    resilience.inject("dist.spgemm", kind="error", count=1)
    C1 = P.dist_spgemm(dA, dA).to_csr()
    c1 = counts("dist.spgemm")
    out["spgemm"] = {"retries": c1[0] - c0[0],
                     "same": all(torch.equal(getattr(C0, k), getattr(C1, k))
                                 for k in ("data", "indices", "indptr"))}
    resilience.reset()

    # The nested site: the first residual's product is the dist.spmv
    # site, the loop's products are not.
    o0 = obs.counters.snapshot()
    resilience.inject("dist.spmv", kind="error", count=2)
    x2, it2 = P.dist_cg(dA, b, maxiter=100)
    o1 = obs.counters.snapshot()

    def d(k):
        return o1.get(k, 0) - o0.get(k, 0)

    out["nested"] = {"injected": d("resil.fault.dist.spmv.injected"),
                     "spmv_retries": d("resil.retry.dist.spmv"),
                     "cg_retries": d("resil.retry.dist.cg"),
                     "iters": int(it2),
                     "same": bool(np.array_equal(
                         x0, x2.full_tensor().numpy()))}
    resilience.reset()

    # The semiring arm retries under the same site.
    sr_clean = P.dist_spmv(dA, xv, semiring="min-plus").full_tensor().numpy()
    resilience.inject("dist.spmv", kind="error", count=1)
    sr = P.dist_spmv(dA, xv, semiring="min-plus").full_tensor().numpy()
    out["semiring"] = {"same": bool(np.array_equal(sr_clean, sr)),
                       "fired": resilience.faults.fired("dist.spmv")}
    resilience.reset()
    settings.resil = False
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def port(jax_side):
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_ranks, WORLD, backend="gloo", timeout=RANK_TIMEOUT,
                     threads=1)[0]


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    import legate_sparse_tpu as jsparse
    from legate_sparse_tpu import obs, resilience
    from legate_sparse_tpu.parallel import (dist_cg, dist_spgemm, dist_spmv,
                                            make_row_mesh, shard_csr)
    from legate_sparse_tpu.settings import settings

    if len(jax.devices("cpu")) < WORLD:
        pytest.skip("needs 8 virtual devices")
    saved = {k: getattr(settings, k) for k in _KNOBS}
    out = {}
    try:
        settings.resil = True
        settings.resil_backoff_ms = 0.0
        resilience.reset()
        dA = shard_csr(jsparse.csr_array(tridiag(256)),
                       mesh=make_row_mesh(jax.devices("cpu")[:WORLD]))
        xv = jnp.ones((dA.rows_padded,), jnp.float32)
        b = np.ones(256, np.float32)
        y = np.asarray(dist_spmv(dA, xv))
        x0, it0 = dist_cg(dA, b, maxiter=100)
        out["spmv"] = {"y": y}
        out["cg"] = {"x": np.asarray(x0), "iters": int(it0)}
        C = dist_spgemm(dA, dA).to_csr()
        out["spgemm"] = {"nnz": int(C.nnz)}
        o0 = obs.counters.snapshot()
        resilience.inject("dist.spmv", kind="error", count=2)
        x2, it2 = dist_cg(dA, b, maxiter=100)
        o1 = obs.counters.snapshot()
        out["nested"] = {k: o1.get(n, 0) - o0.get(n, 0) for k, n in (
            ("injected", "resil.fault.dist.spmv.injected"),
            ("spmv_retries", "resil.retry.dist.spmv"),
            ("cg_retries", "resil.retry.dist.cg"))}
        out["nested"]["iters"] = int(it2)
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        resilience.reset()
    return out


def test_drill_dist_spmv(port, jax_side):
    r = port["spmv"]
    assert (r["retries"], r["injected"], r["same"]) == (2, 2, True)
    np.testing.assert_allclose(r["y"][:256], jax_side["spmv"]["y"][:256],
                               rtol=1e-6, atol=1e-6)


def test_drill_dist_cg(port, jax_side):
    r = port["cg"]
    assert r["retries"] == 1 and r["same"]
    assert r["iters"] == (jax_side["cg"]["iters"],) * 2
    np.testing.assert_allclose(r["x"], jax_side["cg"]["x"][:256],
                               rtol=1e-5, atol=1e-5)


def test_drill_dist_spgemm(port):
    r = port["spgemm"]
    assert r["retries"] == 1 and r["same"]


def test_nested_site_retry_inside_dist_cg(port, jax_side):
    """``dist.spmv`` retried twice at the first residual, ``dist.cg``
    not at all, the solve bit for bit the clean one: the JAX package's
    counts."""
    r, j = port["nested"], jax_side["nested"]
    assert (r["injected"], r["spmv_retries"], r["cg_retries"]) == (2, 2, 0)
    assert {k: r[k] for k in j} == j
    assert r["same"]


def test_semiring_arm_retries_under_dist_spmv(port):
    assert port["semiring"] == {"same": True, "fired": 1}


# ------------------------------------------------------ fault-site coverage --

# A quoted dotted lowercase name as the first argument of a site-taking
# entry point (``tools/lint/rules/fault_sites.py``'s pattern).
SITE_CALL_RE = re.compile(
    r"(?:fault_point|guarded_call|_resil_guarded|\brun)\(\s*\n?\s*"
    r"[\"']([a-z][a-z0-9_]*(?:\.[a-z0-9_]+)+)[\"']")


def site_problems(catalog, default_sites, pkg_dir=PKG_DIR):
    """The port's fault-site drift: a call-site literal outside the
    catalog, a catalog site quoted nowhere in the package outside
    ``resilience/faults.py`` (its call was dropped), or a chaos pool
    site outside the catalog."""
    calls, quoted = {}, set()
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                text = f.read()
            for site in SITE_CALL_RE.findall(text):
                calls.setdefault(site, []).append(fn)
            if path.endswith(os.path.join("resilience", "faults.py")):
                continue
            quoted |= {s for s in catalog
                       if f'"{s}"' in text or f"'{s}'" in text}
    problems = [f"call site uses unregistered name {s!r}"
                for s in sorted(set(calls) - set(catalog))]
    problems += [f"catalog site {s!r} has no call-site literal"
                 for s in sorted(set(catalog) - quoted)]
    problems += [f"chaos pool site {s!r} is not in the catalog"
                 for s in default_sites if s not in catalog]
    return problems


def test_every_catalog_site_has_a_call_in_the_port():
    from legate_sparse_tpu_torch.resilience.chaos import DEFAULT_SITES
    from legate_sparse_tpu_torch.resilience.faults import CATALOG

    assert site_problems(CATALOG, DEFAULT_SITES) == []


def test_port_catalog_is_the_jax_catalog():
    from legate_sparse_tpu.resilience.chaos import DEFAULT_SITES as JSITES
    from legate_sparse_tpu.resilience.faults import CATALOG as JCAT

    from legate_sparse_tpu_torch.resilience.chaos import DEFAULT_SITES
    from legate_sparse_tpu_torch.resilience.faults import CATALOG

    assert sorted(CATALOG) == sorted(JCAT)
    assert DEFAULT_SITES == JSITES


def test_site_check_catches_an_orphan():
    """A catalog entry with no call-site literal fails the check — the
    rot it exists to catch."""
    from legate_sparse_tpu_torch.resilience.chaos import DEFAULT_SITES
    from legate_sparse_tpu_torch.resilience.faults import CATALOG

    cat = dict(CATALOG, **{"engine.plan.nonexistent_site": "probe"})
    probs = site_problems(cat, DEFAULT_SITES)
    assert len(probs) == 1 and "nonexistent_site" in probs[0]


def test_site_check_catches_an_unregistered_call(tmp_path):
    (tmp_path / "mod.py").write_text(
        'fault_point("engine.unknown.site")\n'
        + "".join(f'x = "{s}"\n' for s in
                  __import__("legate_sparse_tpu_torch.resilience.faults",
                             fromlist=["CATALOG"]).CATALOG))
    from legate_sparse_tpu_torch.resilience.faults import CATALOG

    probs = site_problems(CATALOG, (), pkg_dir=str(tmp_path))
    assert probs == ["call site uses unregistered name "
                     "'engine.unknown.site'"]
