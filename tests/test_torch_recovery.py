# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Fault-tolerant solves of the port against the JAX package's
(``tests/test_recovery.py``): checkpoints at the fetch cadence, the
device-loss recovery ladder (detect -> shrink -> reshard -> restore ->
resume) on a survivor mesh, the ABFT-checked ``dist_spmv``, the
refinement fetch's deadline and the inertness of all of it with
``settings.resil`` off.

The single-device cases run in the pytest process on both packages (the
port on ``device="cpu"``).  The distributed ones run once on each side:
the JAX package on its 8-device CPU mesh, the port on 8 gloo ranks
(one spawn, ``parallel.launch.run_ranks``; this module imports no JAX
at its top, since the ranks import it to find their function).  Every
rank arms the same fault schedule, so every rank sees a loss at the
same fetch; the lost rank joins the creation of the survivor mesh and
leaves the solve raising ``DeviceLost`` (ROADMAP queue 3, item 16).

Held equal to the JAX package's: iteration counts, and the movement of
every ``resil.recovery.*`` and ``resil.ckpt.*`` counter except
``resil.ckpt.ms`` (a time) and ``resil.recovery.reshard_bytes``, which
both packages hold above 0 (the port counts its survivors' new blocks,
the JAX package its upload bytes).  x on the survivors within 1e-5 of
the JAX package's (f32; both solve to the same iteration plan, their
dot products summed in another order).  The port's CG fetches at
``maxiter - 1`` as well, where the JAX package tests on the device: one
more ``transfer.host_sync.cg_conv`` than the JAX chunked loop, exactly
as many as the port's own plain loop.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

WORLD = 8
RANK_TIMEOUT = 240.0
_KNOBS = ("resil", "resil_retries", "resil_backoff_ms",
          "resil_retry_budget", "resil_breaker_k",
          "resil_breaker_cooldown_ms", "resil_health", "resil_ckpt_iters",
          "resil_abft")

# name -> (solver, site, after, lost ordinal, checkpoint cadence or None
# for the settings knob, keywords)
LADDER = {
    "cg": ("cg", "solver.cg.conv", 2, 1, 10,
           {"rtol": 0.0, "maxiter": 60, "conv_test_iters": 10}),
    "cg-no-snapshot": ("cg", "solver.cg.conv", 0, 0, 0,
                       {"rtol": 0.0, "maxiter": 40, "conv_test_iters": 10}),
    "gmres": ("gmres", "solver.gmres.conv", 1, 2, 10,
              {"restart": 10, "rtol": 1e-8, "maxiter": 100}),
    "cg-knob": ("cg", "solver.cg.conv", 2, 1, None,
                {"rtol": 0.0, "maxiter": 60, "conv_test_iters": 10}),
}
HELD = ("resil.recovery.attempts", "resil.recovery.device_loss",
        "resil.recovery.mesh_shrink", "resil.recovery.succeeded",
        "resil.recovery.restored_iters", "resil.ckpt.saves",
        "resil.ckpt.bytes", "resil.ckpt.restores")


def tridiag(n, dtype=np.float32):
    return sp.diags([np.full(n, 4.0, dtype), np.full(n - 1, -1.0, dtype),
                     np.full(n - 1, -1.0, dtype)], [0, 1, -1], format="csr",
                    dtype=dtype)


def ref_solve(n):
    return spla.spsolve(tridiag(n).astype(np.float64).tocsc(), np.ones(n))


def moved(c0, c1, prefixes=("resil.recovery.", "resil.ckpt.")):
    keys = set(c0) | set(c1)
    return {k: c1.get(k, 0) - c0.get(k, 0) for k in keys
            if k.startswith(prefixes) and c1.get(k, 0) != c0.get(k, 0)}


# ------------------------------------------------------------- the ranks --

def _ladder_case(P, obs, resil, rckpt, settings, dA, name):
    import torch.distributed as dist

    solver, site, after, lost, every, kw = LADDER[name]
    b = np.ones(dA.shape[0], np.float32)
    resil.reset()
    settings.resil_ckpt_iters = 10 if every is None else 0
    c0 = obs.counters.snapshot()
    resil.inject(site, "device_loss", after=after, device=lost)
    fn = P.dist_cg if solver == "cg" else P.dist_gmres
    try:
        if every is None:
            x, it = fn(dA, b, **kw)
        else:
            with rckpt.scope("dist." + solver, every=every):
                x, it = fn(dA, b, **kw)
        rec = {"status": "ok", "iters": int(it),
               "x": x.full_tensor().numpy(),
               "shards": x.device_mesh.size()}
    except resil.DeviceLost as e:
        rec = {"status": "lost", "device": e.device}
    rec["moved"] = moved(c0, obs.counters.snapshot())
    rec["fired"] = resil.faults.fired(site)
    resil.reset()
    settings.resil_ckpt_iters = 0
    dist.barrier()
    return rec


def _ranks(rank, world):
    import torch.distributed as dist

    import legate_sparse_tpu_torch as tsparse
    from legate_sparse_tpu_torch import obs, parallel as P, resilience
    from legate_sparse_tpu_torch import runtime
    from legate_sparse_tpu_torch.parallel.dist_csr import shard_vector
    from legate_sparse_tpu_torch.resilience import checkpoint as rckpt
    from legate_sparse_tpu_torch.settings import settings

    runtime.set_device("cpu")
    out = {}
    A = tsparse.csr_array(tridiag(256), device="cpu")
    dA = P.shard_csr(A)
    out["shards"] = dA.num_shards

    # Inertness first, with the layer off.
    b = np.ones(256, np.float32)
    xv = shard_vector(torch.ones(256), dA.mesh, dA.rows_padded)
    P.dist_spmv(dA, xv)
    c0 = obs.counters.snapshot()
    P.dist_spmv(dA, xv)
    P.dist_cg(dA, b, maxiter=50)
    c1 = obs.counters.snapshot()
    out["off_moved"] = sorted(
        k for k in moved(c0, c1, ("resil.ckpt", "resil.recovery",
                                  "resil.abft", "op.reshard")))

    settings.resil = True
    settings.resil_backoff_ms = 0.0
    # An expired deadline: the ranks agree on it (one all-reduce of the
    # verdict) and all raise before the first stretch.
    try:
        with resilience.deadline.scope(0.0):
            P.dist_cg(dA, b, maxiter=50)
        out["deadline"] = "returned"
    except resilience.DeadlineExceeded as e:
        out["deadline"] = (e.site, e.iterations,
                           obs.counters.get("resil.deadline.solver"))
    dist.barrier()
    out["ladder"] = {name: _ladder_case(P, obs, resilience, rckpt, settings,
                                        dA, name) for name in LADDER}
    out["dA_shards_after"] = dA.num_shards

    # The last shard: a one-rank survivor mesh (every rank joins its
    # creation); on it the loss re-raises with no attempt.
    one = P.survivor_mesh(dA.mesh, list(range(1, world)))
    if rank == 0:
        d1 = P.shard_csr(tsparse.csr_array(tridiag(128), device="cpu"),
                         mesh=one)
        resilience.inject("solver.cg.conv", "device_loss", after=0,
                          device=0)
        a0 = obs.counters.get("resil.recovery.attempts")
        try:
            with rckpt.scope("dist.cg", every=10):
                P.dist_cg(d1, np.ones(128, np.float32), rtol=0.0,
                          maxiter=40, conv_test_iters=10)
            out["last_shard"] = "returned"
        except resilience.DeviceLost:
            out["last_shard"] = ("raised", obs.counters.get(
                "resil.recovery.attempts") - a0, d1.num_shards)
        resilience.reset()
    dist.barrier()

    # reshard onto the survivors of a loss of the last rank: a
    # repartition of the kept source, which still solves.
    A128 = tsparse.csr_array(tridiag(128), device="cpu")
    d128 = P.shard_csr(A128)
    small = P.survivor_mesh(d128.mesh, world - 1)
    if rank != world - 1:
        B = P.reshard(d128, mesh=small)
        x, _it = P.dist_cg(B, np.ones(128, np.float32), rtol=1e-8,
                           maxiter=300)
        out["shrink"] = {"shards": B.num_shards, "x": x.full_tensor().numpy(),
                         "layout": B.layout, "rps": B.rows_per_shard}
    dist.barrier()

    # ABFT.
    settings.resil_abft = True
    c0 = obs.counters.snapshot()
    clean = P.dist_spmv(dA, xv).full_tensor().numpy()
    c1 = obs.counters.snapshot()
    abft = {"clean": clean, "clean_moved": moved(c0, c1, ("resil.",))}
    c0 = c1
    resilience.inject("dist.spmv.abft", kind="nonfinite", count=1)
    y = P.dist_spmv(dA, xv).full_tensor().numpy()
    c1 = obs.counters.snapshot()
    abft["retried"] = y
    abft["retried_moved"] = moved(c0, c1, ("resil.abft", "resil.retry"))
    resilience.reset()
    settings.resil_retries = 1
    resilience.inject("dist.spmv.abft", kind="nonfinite", count=5)
    try:
        P.dist_spmv(dA, xv)
        abft["exhausted"] = "returned"
    except resilience.ChecksumError as e:
        abft["exhausted"] = ("raised", e.site)
    resilience.reset()
    settings.resil_retries = 2
    settings.resil_abft = False
    c0 = obs.counters.snapshot()
    P.dist_spmv(dA, xv)
    abft["off_checks"] = (obs.counters.snapshot().get("resil.abft.checks", 0)
                          - c0.get("resil.abft.checks", 0))
    out["abft"] = abft
    settings.resil = False
    return out


@pytest.fixture(scope="module")
def port(jax_side):
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_ranks, WORLD, backend="gloo", timeout=RANK_TIMEOUT,
                     threads=1)


@pytest.fixture(scope="module")
def jax_side():
    import jax

    import legate_sparse_tpu as jsparse
    from legate_sparse_tpu import obs, resilience
    from legate_sparse_tpu.parallel import (dist_cg, dist_gmres,
                                            make_row_mesh, shard_csr)
    from legate_sparse_tpu.resilience import checkpoint as rckpt
    from legate_sparse_tpu.settings import settings

    if len(jax.devices("cpu")) < WORLD:
        pytest.skip("needs 8 virtual devices")
    saved = {k: getattr(settings, k) for k in _KNOBS}
    out = {}
    try:
        settings.resil = True
        settings.resil_backoff_ms = 0.0
        dA = shard_csr(jsparse.csr_array(tridiag(256)),
                       mesh=make_row_mesh(jax.devices("cpu")[:WORLD]))
        for name, (solver, site, after, lost, every, kw) in LADDER.items():
            resilience.reset()
            settings.resil_ckpt_iters = 10 if every is None else 0
            c0 = obs.counters.snapshot()
            resilience.inject(site, "device_loss", after=after, device=lost)
            fn = dist_cg if solver == "cg" else dist_gmres
            if every is None:
                x, it = fn(dA, np.ones(256, np.float32), **kw)
            else:
                with rckpt.scope("dist." + solver, every=every):
                    x, it = fn(dA, np.ones(256, np.float32), **kw)
            out[name] = {"iters": int(it), "x": np.asarray(x),
                         "moved": moved(c0, obs.counters.snapshot()),
                         "fired": resilience.faults.fired(site)}
        resilience.reset()
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        resilience.reset()
    return out


def _survivor(port, name):
    """(survivor records, lost rank records) of a ladder case."""
    recs = [r["ladder"][name] for r in port]
    return ([r for r in recs if r["status"] == "ok"],
            [(i, r) for i, r in enumerate(recs) if r["status"] == "lost"])


# ------------------------------------------------------ the recovery ladder --

@pytest.mark.parametrize("name", sorted(LADDER))
def test_ladder_iterations_and_counters_equal_jax(port, jax_side, name):
    """The survivors' iterations and every held ``resil.recovery.*`` /
    ``resil.ckpt.*`` movement equal the JAX package's; the reshard
    moved bytes on both sides; the fault fired once."""
    ok, _lost = _survivor(port, name)
    j = jax_side[name]
    assert len(ok) == WORLD - 1
    for r in ok:
        assert r["iters"] == j["iters"], name
        for k in HELD:
            assert r["moved"].get(k, 0) == j["moved"].get(k, 0), (name, k)
        assert r["moved"]["resil.recovery.reshard_bytes"] > 0
        assert r["fired"] == j["fired"] == 1
        assert r["shards"] == WORLD - 1
    assert j["moved"]["resil.recovery.reshard_bytes"] > 0


@pytest.mark.parametrize("name", sorted(LADDER))
def test_ladder_solution_equals_jax_and_scipy(port, jax_side, name):
    """x on every survivor within 1e-5 of the JAX package's, the same on
    each survivor bit for bit, and within the JAX test's tolerance of
    scipy's direct solve."""
    ok, _lost = _survivor(port, name)
    j = jax_side[name]["x"][:256]
    ref = ref_solve(256)
    tol = (1e-4, 1e-5) if name == "gmres" else (1e-5, 1e-6)
    for r in ok:
        np.testing.assert_array_equal(r["x"], ok[0]["x"])
        np.testing.assert_allclose(r["x"], j, rtol=1e-5, atol=1e-5)
        assert np.allclose(r["x"], ref, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("name", sorted(LADDER))
def test_lost_rank_raises_device_lost(port, name):
    """Exactly the armed ordinal's rank left the solve with
    ``DeviceLost``, and moved none of the recovery counters."""
    _ok, lost = _survivor(port, name)
    ordinal = LADDER[name][3]
    assert [i for i, _r in lost] == [ordinal]
    rec = lost[0][1]
    assert rec["device"] == ordinal
    assert not any(k.startswith("resil.recovery.") for k in rec["moved"])


def test_dist_deadline_agreed_by_every_rank(port):
    """Under an expired deadline every rank raises ``DeadlineExceeded``
    at the same check (the verdict all-reduced), none hangs."""
    assert all(r["deadline"] == ("solver.cg.conv", 0, 1) for r in port)


def test_caller_matrix_untouched(port):
    """The ladder reshards a copy: the caller's matrix keeps its mesh."""
    assert all(r["dA_shards_after"] == r["shards"] == WORLD for r in port)


def test_device_loss_on_last_shard_reraises(port):
    """On a one-rank (survivor) mesh the loss re-raises with no attempt."""
    assert port[0]["last_shard"] == ("raised", 0, 1)


def test_matrix_reshard_shrink_is_a_repartition(port):
    """The survivors of a loss of the last rank repartition the kept
    source (7 row blocks) and still solve (``test_reshard.py:106``)."""
    recs = [r["shrink"] for r in port[:-1]]
    assert "shrink" not in port[-1]
    ref = tridiag(128).astype(np.float64)
    for r in recs:
        assert r["shards"] == WORLD - 1 and r["layout"] == "1d-row"
        assert r["rps"] == -(-128 // (WORLD - 1))
        np.testing.assert_array_equal(r["x"], recs[0]["x"])
        assert np.allclose(ref @ r["x"][:128].astype(np.float64),
                           np.ones(128), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- ABFT --

def test_abft_clean_pass_counts_checks_only(port):
    ref = tridiag(256).astype(np.float64) @ np.ones(256)
    for r in port:
        a = r["abft"]
        assert a["clean_moved"] == {"resil.abft.checks": 1}
        np.testing.assert_allclose(a["clean"][:256], ref, rtol=1e-5,
                                   atol=1e-6)


def test_abft_mismatch_is_typed_counted_retry(port):
    """A poisoned y is one mismatch and one ``dist.spmv`` retry, and the
    result is bit for bit the clean one."""
    for r in port:
        a = r["abft"]
        assert a["retried_moved"].get("resil.abft.mismatch") == 1
        assert a["retried_moved"].get("resil.retry.dist.spmv") == 1
        np.testing.assert_array_equal(a["retried"], a["clean"])


def test_abft_exhausted_retries_surface_checksum_error(port):
    assert all(r["abft"]["exhausted"] == ("raised", "dist.spmv.abft")
               for r in port)


def test_abft_off_is_counter_inert(port):
    assert all(r["abft"]["off_checks"] == 0 for r in port)


def test_resil_off_dist_solves_counter_inert(port):
    assert all(r["off_moved"] == [] for r in port)


# ------------------------------------------- single device, both packages --

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

    def tridiag(self, n):
        if self.name == "jax":
            return self.sparse.csr_array(tridiag(n))
        return self.sparse.csr_array(tridiag(n), device="cpu")

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
    p.resil.reset()
    p.obs.counters.reset("resil.")
    yield p
    for k, v in saved.items():
        setattr(p.settings, k, v)
    p.resil.reset()
    runtime.set_device(None)


def _delta(c0, c1, name):
    return int(c1.get(name, 0)) - int(c0.get(name, 0))


def test_checkpoint_rides_cg_fetch_cadence(pkg):
    """A checkpoint scope takes (x, r, p) to the host every 10
    iterations at the fetches the solve makes anyway: 4 saves of 3
    vectors; the port's fetches are its plain loop's (one more, at
    ``maxiter - 1``, than the JAX chunked loop's 4)."""
    A = pkg.tridiag(256)
    b = np.ones(256, np.float32)
    c0 = pkg.obs.counters.snapshot()
    with pkg.resil.checkpoint.scope("t.cg", every=10) as ck:
        x, it = pkg.sparse.linalg.cg(A, b, rtol=0.0, maxiter=40,
                                     conv_test_iters=10)
    c1 = pkg.obs.counters.snapshot()
    assert int(it) == 40
    assert ck.saves == 4 and ck.iterations == 40
    assert len(ck.arrays) == 3
    assert all(isinstance(a, np.ndarray) for a in ck.arrays)
    assert _delta(c0, c1, "resil.ckpt.saves") == 4
    assert _delta(c0, c1, "resil.ckpt.bytes") == 4 * 3 * 256 * 4
    syncs = _delta(c0, c1, "transfer.host_sync.cg_conv")
    if pkg.name == "jax":
        assert syncs == 4
    else:
        pkg.settings.resil = False
        p0 = pkg.obs.counters.snapshot()
        x_plain, _ = pkg.sparse.linalg.cg(A, b, rtol=0.0, maxiter=40,
                                          conv_test_iters=10)
        plain = _delta(p0, pkg.obs.counters.snapshot(),
                       "transfer.host_sync.cg_conv")
        assert syncs == plain == 5
        assert torch.equal(x, x_plain)
    it0, arrays = ck.restore()
    assert it0 == 40
    np.testing.assert_array_equal(arrays[0], pkg.np(x))
    assert _delta(c0, pkg.obs.counters.snapshot(),
                  "resil.ckpt.restores") == 1


def test_checkpoint_rides_gmres_cycle_cadence(pkg):
    A = pkg.tridiag(256)
    b = np.ones(256, np.float32)
    with pkg.resil.checkpoint.scope("t.gmres", every=10) as ck:
        x, it = pkg.sparse.linalg.gmres(A, b, restart=10, rtol=0.0,
                                        maxiter=30)
    assert int(it) == 30
    assert ck.saves == 3
    assert len(ck.arrays) == 1
    np.testing.assert_array_equal(ck.arrays[0], pkg.np(x))


def test_checkpoint_zero_cadence_never_snapshots(pkg):
    A = pkg.tridiag(128)
    with pkg.resil.checkpoint.scope("t.cg", every=0) as ck:
        pkg.sparse.linalg.cg(A, np.ones(128, np.float32), maxiter=50)
    assert ck.saves == 0
    assert ck.restore() is None


def test_checkpoint_saves_equal_between_packages():
    """The same cadence drill on both packages: equal saves, bytes and
    the snapshot's iterate within 1e-6 (f32)."""
    got = {}
    for name in ("jax", "torch"):
        from legate_sparse_tpu_torch import runtime

        runtime.set_device("cpu")
        p = _Pkg(name)
        saved = p.settings.resil
        p.settings.resil = True
        try:
            with p.resil.checkpoint.scope("t", every=25) as ck:
                p.sparse.linalg.cg(p.tridiag(200), np.ones(200, np.float32),
                                   rtol=0.0, maxiter=100)
            got[name] = (ck.saves, ck.nbytes, ck.iterations, ck.arrays[0])
        finally:
            p.settings.resil = saved
            runtime.set_device(None)
    assert got["jax"][:3] == got["torch"][:3] == (4, 3 * 200 * 4, 100)
    np.testing.assert_allclose(got["torch"][3], got["jax"][3], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_refine_fetch_enforces_deadline(pkg, solver):
    """An expired budget surfaces at the refinement fetch as a typed
    ``DeadlineExceeded`` on the refine site, with the partial iterate."""
    A = pkg.tridiag(512)
    b = np.ones(512, np.float32)
    kw = {"restart": 10} if solver == "gmres" else {}
    with pytest.raises(pkg.resil.DeadlineExceeded) as ei:
        with pkg.resil.deadline.scope(0.0):
            getattr(pkg.sparse.linalg, solver)(A, b, refine=3, maxiter=500,
                                               **kw)
    assert ei.value.site == f"solver.{solver}.refine"
    assert ei.value.partial is not None


def test_refine_completes_under_generous_deadline(pkg):
    A = pkg.tridiag(256)
    with pkg.resil.deadline.scope(60_000.0):
        x, _it = pkg.sparse.linalg.cg(A, np.ones(256, np.float32), refine=3,
                                      maxiter=500)
    assert np.allclose(pkg.np(x), ref_solve(256), rtol=1e-4, atol=1e-4)


def test_resil_off_checkpoint_scope_inert(pkg):
    """With the layer off an open checkpoint scope changes nothing: no
    stretches, no snapshots, the same bits and host syncs."""
    pkg.settings.resil = False
    A = pkg.tridiag(256)
    b = np.ones(256, np.float32)
    p0 = pkg.obs.counters.snapshot()
    x_plain, it_plain = pkg.sparse.linalg.cg(A, b, maxiter=50)
    c0 = pkg.obs.counters.snapshot()
    with pkg.resil.checkpoint.scope("off", every=5) as ck:
        x, it = pkg.sparse.linalg.cg(A, b, maxiter=50)
    c1 = pkg.obs.counters.snapshot()
    assert ck.saves == 0 and int(it) == int(it_plain)
    np.testing.assert_array_equal(pkg.np(x), pkg.np(x_plain))
    assert _delta(c0, c1, "resil.ckpt.saves") == 0
    syncs = _delta(c0, c1, "transfer.host_sync.cg_conv")
    # The JAX one-shot loop fetches nothing; the port's plain loop once
    # at each convergence test it reaches.
    assert syncs == _delta(p0, c0, "transfer.host_sync.cg_conv")
    assert syncs == (0 if pkg.name == "jax" else 1)
