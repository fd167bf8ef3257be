# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's elastic placement (``placement/``: ``submesh``,
``controller``, ``migrate``; the gateway's two branches; the drill's
``migration=``) against the JAX package's: the 20 cases of
``tests/test_placement.py``, one for one, and the port's SPMD cases.

Tolerance: exact, but for one general-CSR product compared across the
packages (1e-6, f32 rounding of another summation order).  The pure half (``feasible_allocation``, ``carve``,
``price_migration``, ``propose``, the placement table, the doctor's
rules) gives the JAX package's values on the JAX test's inputs and on
fuzzed ones.  The served products are bit for bit the unplaced
``A.dot``.

A device is a rank in the port.  The multi-device cases run on 8 gloo
ranks (one spawn; the rank function in ``utils_test/torch_ops_ranks.py``,
a module without JAX) where the JAX package uses its 8-device mesh;
there every rank registers the same tenants and applies the same
migrations.  The port's own cases there: the controller's decision is
one on every rank when the ranks' local loads differ (their local
proposals are not), and a placed tenant's product makes no collective
on a rank outside its slice (a meter counts every ``torch.distributed``
collective and functional collective the rank calls), every rank's ``y``
the same bits.
"""

import inspect
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from utils_test.tools import load_tool
from utils_test.torch_ops_ranks import random_sp, tridiag_sp, xnp

WORLD = 8
RANK_TIMEOUT = 400.0
_KNOBS = ("gateway", "resil", "resil_retries", "resil_backoff_ms",
          "resil_breaker_k", "resil_breaker_cooldown_ms", "obs_attrib",
          "obs_slo", "placement", "placement_cooldown_ms",
          "placement_watchdog_ms", "placement_amortize",
          "placement_bw_gbps")


class Pkg:
    def __init__(self, name):
        self.name = name
        if name == "jax":
            import legate_sparse_tpu as sparse
            from legate_sparse_tpu import engine, obs, placement, resilience
            from legate_sparse_tpu.settings import settings
        else:
            import legate_sparse_tpu_torch as sparse
            from legate_sparse_tpu_torch import (
                engine, obs, placement, resilience,
            )
            from legate_sparse_tpu_torch.settings import settings
        self.sparse, self.engine, self.obs = sparse, engine, obs
        self.placement, self.resil, self.settings = (placement, resilience,
                                                     settings)
        self.psub = placement.submesh
        self.pctl = placement.controller
        self.counters, self.report = obs.counters, obs.report

    def csr(self, S):
        if self.name == "jax":
            return self.sparse.csr_array(S)
        return self.sparse.csr_array(S, device="cpu")

    def x(self, n, seed=1):
        v = xnp(n, seed)
        return jnp.asarray(v) if self.name == "jax" else torch.from_numpy(v)

    def np(self, y):
        return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)

    def gateway(self, **kw):
        base = dict(max_batch=64, queue_depth=128, tenant_quota=64,
                    rate=0.0, burst=64.0, slack_ms=1.0, timeout_ms=0.0)
        base.update(kw)
        return self.engine.Gateway(self.engine.Engine(), **base)

    def snap(self, devices=WORLD, **kw):
        base = dict(demand={}, qos_weights={}, burns={}, devices=devices,
                    current={}, payload_bytes={}, shrink=())
        base.update(kw)
        return self.pctl.PlacementSnapshot(**base)


def _reset(p):
    p.obs.reset_all()
    p.obs.trace.disable()
    p.obs.context.reset_ids()
    p.placement.reset()
    p.resil.reset()


@pytest.fixture(scope="module")
def pkgs():
    return {"jax": Pkg("jax"), "torch": Pkg("torch")}


@pytest.fixture(autouse=True)
def _isolation(pkgs):
    from legate_sparse_tpu_torch import runtime

    runtime.set_device("cpu")
    saved = {n: {k: getattr(p.settings, k) for k in _KNOBS}
             for n, p in pkgs.items()}
    for p in pkgs.values():
        _reset(p)
    yield
    for n, p in pkgs.items():
        for k, v in saved[n].items():
            setattr(p.settings, k, v)
        _reset(p)
    runtime.set_device(None)


def both(pkgs, case):
    return case(pkgs["jax"]), case(pkgs["torch"])


def _delta(c0, c1, name):
    return int(c1.get(name, 0)) - int(c0.get(name, 0))


# ----------------------------------------------- off-by-default contract --

def test_placement_off_is_bit_for_bit_and_counter_inert(pkgs):
    """``test_placement.py::test_placement_off_is_bit_for_bit_and_counter_inert``:
    flag unset, the armed gateway serves the plain path, no
    ``placement.*`` counter moves, ``step`` returns None and the watchdog
    refuses to start; both packages serve the same bits."""
    def case(p):
        assert p.settings.placement is False
        p.settings.gateway = True
        A = p.csr(tridiag_sp(200))
        xs = [p.x(200, seed=s) for s in range(4)]
        gw = p.gateway()
        try:
            futs = [gw.submit(A, x, tenant="t0", qos="interactive")
                    for x in xs]
            gw.flush()
            ys = [p.np(f.result(timeout=30)) for f in futs]
        finally:
            gw.shutdown()
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(y, p.np(A.dot(x)))
        assert p.counters.snapshot("placement.") == {}
        ctl = p.placement.PlacementController(devices=[0])
        assert ctl.step() is None
        assert ctl.start_watchdog(interval_ms=5) is False
        assert p.counters.snapshot("placement.") == {}
        return ys

    jx, pt = both(pkgs, case)
    for a, b in zip(pt, jx):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ submesh invariants --

def test_feasible_allocation_trims_deterministically(pkgs):
    """``::test_feasible_allocation_trims_deterministically``, plus 200
    fuzzed recommendations: equal allocations."""
    rec = {"tenants": {"a": {"devices": 6, "share": 0.7},
                       "b": {"devices": 3, "share": 0.2},
                       "c": {"devices": 1, "share": 0.1}}}
    rec2 = {"tenants": {t: {"devices": 1, "share": s}
                        for t, s in (("a", 0.5), ("b", 0.3), ("c", 0.2))}}
    for p in pkgs.values():
        assert p.psub.feasible_allocation(rec, 8) == {"a": 4, "b": 3, "c": 1}
        assert p.psub.feasible_allocation(rec2, 2) == {"a": 1, "b": 1}
    rng = np.random.default_rng(7)
    for _ in range(200):
        r = {"tenants": {f"t{i}": {"devices": int(rng.integers(1, 9)),
                                   "share": float(rng.uniform())}
                         for i in range(int(rng.integers(0, 8)))}}
        d = int(rng.integers(1, 17))
        assert pkgs["torch"].psub.feasible_allocation(r, d) == \
            pkgs["jax"].psub.feasible_allocation(r, d)


def test_carve_contiguous_disjoint_sorted(pkgs):
    """``::test_carve_contiguous_disjoint_sorted``, plus fuzzed
    allocations: equal slices, and the same ``ValueError``."""
    for p in pkgs.values():
        slices = p.psub.carve({"b": 3, "a": 2, "c": 1}, 8)
        assert slices == {"a": (0, 2), "b": (2, 3), "c": (5, 1)}
        with pytest.raises(ValueError, match="feasible_allocation"):
            p.psub.carve({"a": 9}, 8)
    rng = np.random.default_rng(8)
    for _ in range(200):
        alloc = {f"t{i}": int(rng.integers(1, 4))
                 for i in range(int(rng.integers(0, 6)))}
        d = int(rng.integers(max(1, sum(alloc.values())), 20))
        s = pkgs["torch"].psub.carve(alloc, d)
        assert s == pkgs["jax"].psub.carve(alloc, d)
        cursor = 0
        for start, count in sorted(s.values()):
            assert start == cursor
            cursor += count


def test_price_migration_is_the_reshard_predictor(pkgs):
    """``::test_price_migration_is_the_reshard_predictor``: the same
    priced volumes for the JAX test's and 100 fuzzed payloads; each
    package's ``payload_bytes`` is its own arrays' bytes."""
    def case(p):
        comm = p.obs.comm
        vols = p.psub.price_migration(1000, 7)
        chunk = -(-1000 // 7)
        assert vols == comm.reshard_volumes(
            moved_chunks=7, chunk_elems=chunk, itemsize=1, shards=7)
        assert p.psub.priced_bytes(vols) == 7 * chunk
        assert p.psub.priced_bytes(p.psub.price_migration(1000, 1)) == 1000
        assert p.psub.price_migration(0, 4) == {}
        A = p.csr(tridiag_sp(64))
        assert p.psub.payload_bytes(A) == sum(
            p.np(a).nbytes for a in (A.data, A.indices, A.indptr))
        rng = np.random.default_rng(9)
        return [p.psub.price_migration(int(rng.integers(0, 10 ** 9)),
                                       int(rng.integers(1, 65)))
                for _ in range(100)]

    jx, pt = both(pkgs, case)
    assert pt == jx


# -------------------------------------------- propose(): purity + logic --

def _propose_snaps(p):
    R = WORLD
    base = dict(demand={"t": {"busy_ns": 1_000, "qos": "interactive"}},
                qos_weights={"interactive": 8.0}, devices=R)
    return [
        p.snap(demand={"noisy": {"busy_ns": 8_000_000_000,
                                 "qos": "interactive"},
                       "quiet": {"busy_ns": 1_000_000_000,
                                 "qos": "background"}},
               qos_weights={"interactive": 8.0, "background": 1.0},
               burns={"interactive": 1000.0}, devices=8,
               payload_bytes={"noisy": 1000, "quiet": 1000}),
        p.snap(),
        p.snap(**base),
        p.snap(**base, payload_bytes={"t": 10 ** 9}),
        p.snap(**base, payload_bytes={"t": 10 ** 9},
               burns={"interactive": p.pctl.BURN_PAGE}),
        p.snap(demand={"t": {"busy_ns": 10 ** 12, "qos": "interactive"},
                       "u": {"busy_ns": 10 ** 10, "qos": "background"}},
               qos_weights={"interactive": 8.0, "background": 1.0},
               devices=8, payload_bytes={"t": 64}),
        p.snap(devices=8, current={"t": (0, 8)}, payload_bytes={"t": 1000},
               shrink=("t",)),
        p.snap(devices=8, current={"t": (0, 1)}, payload_bytes={"t": 1000},
               shrink=("t",)),
        p.snap(demand={"a": {"busy_ns": 10 ** 10, "qos": "interactive"}},
               qos_weights={"interactive": 8.0}, devices=8,
               current={"idle": (0, 4)},
               payload_bytes={"a": 1000, "idle": 1000}),
    ]


def test_propose_is_pure_and_deterministic(pkgs):
    """``::test_propose_is_pure_and_deterministic``: the known values,
    no counter movement, the source-level purity guard, and equal
    decisions in both packages."""
    t = pkgs["torch"]
    d1 = t.pctl.propose(_propose_snaps(t)[0])
    assert d1 == t.pctl.propose(_propose_snaps(t)[0])
    assert (d1.act, d1.reason) == (True, "burning")
    assert d1.allocation == {"noisy": 7, "quiet": 1}
    assert d1.slices == {"noisy": (0, 7), "quiet": (7, 1)}
    chunk = -(-1000 // 7)
    assert d1.priced_bytes == {"noisy": 7 * chunk, "quiet": 1000}
    assert d1.predicted_saving_ns == pytest.approx(8e9 * (1 - 4 / 7))
    c0 = t.counters.snapshot("")
    t.pctl.propose(_propose_snaps(t)[0])
    assert t.counters.snapshot("") == c0
    src = inspect.getsource(t.pctl.propose)
    for banned in ("time.", "_counters", "_rsettings", "_trace",
                   "monotonic", "perf_counter"):
        assert banned not in src, banned
    jx, pt = both(pkgs, lambda p: [tuple(p.pctl.propose(s))
                                   for s in _propose_snaps(p)])
    assert pt == jx


def test_propose_hold_and_override_reasons(pkgs):
    """``::test_propose_hold_and_override_reasons``."""
    t = pkgs["torch"]
    s = _propose_snaps(t)
    got = [(d.act, d.reason) for d in map(t.pctl.propose, s[1:6])]
    assert got == [(False, "no_demand"), (False, "steady"),
                   (False, "unamortized"), (True, "burning"),
                   (True, "amortized")]
    d = t.pctl.propose(s[5])
    assert d.predicted_saving_ns >= d.priced_cost_ns


def test_propose_shrink_halves_flagged_tenant(pkgs):
    """``::test_propose_shrink_halves_flagged_tenant``."""
    t = pkgs["torch"]
    s = _propose_snaps(t)
    d = t.pctl.propose(s[6])
    assert (d.act, d.reason, d.allocation["t"], d.moves) == \
        (True, "shrink", 4, {"t": (0, 4)})
    d = t.pctl.propose(s[7])
    assert (d.act, d.reason) == (False, "steady")


def test_propose_keep_your_slice_re_trims(pkgs):
    """``::test_propose_keep_your_slice_re_trims``."""
    d = pkgs["torch"].pctl.propose(_propose_snaps(pkgs["torch"])[8])
    assert sum(d.allocation.values()) <= 8
    assert d.allocation["idle"] >= 1


def test_propose_equal_on_fuzzed_snapshots(pkgs):
    """300 fuzzed snapshots (demand, weights, burns, current slices,
    payloads, shrink flags): the same decision in both packages."""
    rng = np.random.default_rng(11)
    qos = ["interactive", "batch", "background", None]
    weights = {"interactive": 8.0, "batch": 4.0, "background": 1.0}
    snaps = []
    for _ in range(300):
        devices = int(rng.integers(1, 17))
        names = [f"t{i}" for i in range(int(rng.integers(0, 6)))]
        demand = {n: {"busy_ns": int(rng.integers(0, 10 ** 11)),
                      "qos": qos[int(rng.integers(4))]} for n in names}
        current, start = {}, 0
        for n in names:
            if rng.uniform() < 0.4 and start < devices:
                cnt = int(rng.integers(1, devices - start + 1))
                current[n] = (start, cnt)
                start += cnt
        snaps.append(dict(
            demand=demand, qos_weights=weights,
            burns={q: float(rng.choice([0.0, 2.0, 14.4, 500.0]))
                   for q in qos[:3]},
            devices=devices, current=current,
            payload_bytes={n: int(rng.integers(0, 10 ** 8))
                           for n in names if rng.uniform() < 0.7},
            shrink=tuple(sorted(n for n in current if rng.uniform() < 0.3))))
    for kw in snaps:
        for bw, am in ((10.0, 1.0), (0.5, 3.0)):
            assert tuple(pkgs["torch"].pctl.propose(
                pkgs["torch"].snap(**kw), bw_gbps=bw, amortize=am)) == \
                tuple(pkgs["jax"].pctl.propose(
                    pkgs["jax"].snap(**kw), bw_gbps=bw, amortize=am))


# ------------------------------------- registry: place / route / migrate --

def test_place_requires_square(pkgs):
    """``::test_place_requires_square``."""
    for p in pkgs.values():
        A = p.csr(np.ones((4, 6), np.float32))
        with pytest.raises(ValueError, match="square"):
            p.placement.place("t", A)
        with pytest.raises(KeyError, match="not placed"):
            p.placement.migrate_to("ghost", 2, [0, 1])


def test_gateway_routes_placed_tenant_inline(pkgs):
    """``::test_gateway_routes_placed_tenant_inline`` (one process: the
    port's engine serves no matrix on a job of several ranks): placed
    traffic serves inline at admission, another tenant's copy of the
    matrix is not routed; equal counter movement."""
    def case(p):
        p.settings.gateway = p.settings.placement = True
        A, x = p.csr(random_sp(400)), p.x(400, seed=5)
        p.placement.place("pt", A)
        gw = p.gateway()
        c0 = p.counters.snapshot("")
        try:
            fut = gw.submit(A, x, tenant="pt", qos="interactive")
            assert fut.done()
            y = p.np(fut.result())
            np.testing.assert_array_equal(y, p.np(A.dot(x)))
            fut2 = gw.submit(A, x, tenant="other", qos="interactive")
            gw.flush()
            fut2.result(timeout=30)
        finally:
            gw.shutdown()
        c1 = p.counters.snapshot("")
        return (_delta(c0, c1, "placement.routes"),
                _delta(c0, c1, "gateway.inline"), y)

    jx, pt = both(pkgs, case)
    assert pt[:2] == jx[:2] == (1, 1)
    # Across the packages a general CSR product sums in another order:
    # held at f32 rounding (each package's placed product is its own
    # unplaced one bit for bit, above).
    np.testing.assert_allclose(pt[2], jx[2], rtol=1e-6, atol=1e-6)


def test_migration_one_device_priced_and_versioned(pkgs):
    """``::test_migration_priced_equals_measured_and_swaps_version`` on
    one device (the chip's shape; the 8-rank case is below): a carve
    onto a one-device slice records the priced bytes exactly, bumps the
    version, and the handle serves the unplaced bits."""
    def case(p):
        A, x = p.csr(tridiag_sp(256)), p.x(256, seed=3)
        p.placement.place("pt", A)
        reg = p.placement.registry()
        c0 = p.counters.snapshot("")
        moved = p.placement.migrate_to("pt", 1, [0] if p.name == "torch"
                                       else jax.devices()[:1])
        c1 = p.counters.snapshot("")
        priced = p.psub.priced_bytes(p.psub.price_migration(
            reg.payload_bytes()["pt"], 1))
        h = p.placement.route(A, "pt")
        np.testing.assert_array_equal(p.np(h.dot(x)), p.np(A.dot(x)))
        return (moved == priced == _delta(c0, c1,
                                          "comm.dist_reshard.ppermute_bytes"),
                h.version, reg.slices()["pt"], h._dist is None)

    jx, pt = both(pkgs, case)
    assert pt == jx == (True, 1, (0, 1), True)


def test_controller_watchdog_ticks(pkgs):
    """``::test_controller_watchdog_ticks`` in one process (on a job of
    several ranks the watchdog does not start: see the 8-rank cases)."""
    p = pkgs["torch"]
    p.settings.placement = True
    ctl = p.placement.PlacementController(devices=[0], cooldown_ms=10 ** 6)
    ctl.snapshot = lambda: p.snap(devices=1)
    assert ctl.start_watchdog(interval_ms=0) is False
    assert ctl.start_watchdog(interval_ms=5) is True
    assert ctl.start_watchdog(interval_ms=5) is True
    deadline = time.monotonic() + 5.0
    try:
        while (p.counters.get("placement.watchdog.ticks") < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        ctl.stop_watchdog()
    assert p.counters.get("placement.watchdog.ticks") >= 2
    assert p.counters.get("placement.hold.no_demand") >= 1


def test_chaos_migration_scenario_requires_placement(pkgs):
    """``::test_chaos_migration_scenario_requires_placement``."""
    for p in pkgs.values():
        p.settings.gateway = p.settings.resil = True
        with pytest.raises(RuntimeError, match="settings.placement"):
            p.resil.chaos.run_drill(
                None, tenants=[], migration={"tenant": "t",
                                             "devices": (2, 4)})


def test_chaos_drill_migration_one_device(pkgs):
    """The drill's ``migration=`` on one device (the chip's shape,
    slices (1, 1)): both packages hold the drill's invariants with the
    same per-tenant ledgers."""
    def case(p):
        p.settings.gateway = p.settings.resil = p.settings.placement = True
        p.settings.resil_backoff_ms = 0.0
        p.resil.reset()
        gw = p.gateway(max_batch=8)
        try:
            rep = p.resil.chaos.run_drill(
                gw, tenants=[
                    {"name": "good", "qos": "interactive",
                     "A": p.csr(tridiag_sp(256)),
                     "xs": [p.x(256, seed=s) for s in range(3)]},
                    {"name": "storm", "qos": "background",
                     "A": p.csr(tridiag_sp(192)),
                     "xs": [p.x(192, seed=s) for s in range(10, 13)],
                     "deadline_ms": 0.0}],
                rounds=4, seed=7,
                migration={"tenant": "good", "devices": (1, 1)})
        finally:
            gw.shutdown()
        assert rep.ok(), rep.violations
        return rep.migrations, rep.submitted, rep.per_tenant

    jx, pt = both(pkgs, case)
    assert pt == jx
    assert pt[0] == 2 and pt[2]["good"]["served"] == 12


# --------------------------------------------------- ledger + doctor --

def test_render_placement_table(pkgs):
    """``::test_render_placement_table``: equal text."""
    ctrs = {"placement.steps": 3, "placement.proposals": 3,
            "placement.hold.cooldown": 1, "placement.migrations": 1,
            "placement.migration.bytes": 1001,
            "comm.dist_reshard.ppermute_bytes": 1001,
            "placement.placed": 2, "placement.routes": 5}
    jx, pt = both(pkgs, lambda p: (p.report.render_placement_table({}),
                                   p.report.render_placement_table(ctrs)))
    assert pt == jx
    assert "placement off" in pt[0]
    assert "controller: 3 steps" in pt[1]
    assert "migrations: 1 applied" in pt[1] and "1001" in pt[1]


def test_doctor_migration_thrash_and_disabled_rules():
    """``::test_doctor_migration_thrash_and_disabled_rules``: the port's
    doctor gives ``tools/doctor.py``'s findings."""
    from legate_sparse_tpu_torch.obs import doctor

    jdoctor = load_tool("doctor")
    hog = {"attrib.tenant.hog.wall_ns": 9e9,
           "attrib.tenant.meek.wall_ns": 1e9,
           "slo.breach.gateway.interactive": 2}
    out = []
    for ctrs in ({"placement.thrash": 2}, hog,
                 dict(hog, **{"placement.steps": 1})):
        ev, jev = doctor.Evidence(), jdoctor.Evidence()
        ev.counters, jev.counters = dict(ctrs), dict(ctrs)
        findings = doctor.diagnose(ev)
        assert findings == jdoctor.diagnose(jev)
        out.append({f["code"]: f for f in findings})
    thrash = out[0]["migration-thrash"]
    assert (thrash["severity"], thrash["value"]) == ("warn", "2")
    assert "2x" in thrash["message"]
    assert "placement-disabled-while-noisy-neighbor" in out[1]
    assert "noisy-neighbor" in out[2]
    assert "placement-disabled-while-noisy-neighbor" not in out[2]


# --------------------------------------------------- the 8-rank cases --

@pytest.fixture(scope="module")
def jax_mesh_cases():
    """The JAX package's side of the multi-device cases, on its 8-device
    mesh (run before the ranks spawn)."""
    from legate_sparse_tpu.parallel.dist_csr import mesh_fingerprint

    if len(jax.devices()) < WORLD:
        pytest.skip("needs 8 virtual devices")
    p = Pkg("jax")
    DEVS = list(jax.devices())[:WORLD]
    _reset(p)
    out = {}
    try:
        m1, m2 = p.psub.build_submesh(DEVS, 0, 2), \
            p.psub.build_submesh(DEVS, 0, 2)
        out["fp_equal"] = mesh_fingerprint(m1) == mesh_fingerprint(m2)
        A, x = p.csr(tridiag_sp(256)), p.x(256, seed=3)
        p.placement.place("pt", A)
        payload = p.placement.registry().payload_bytes()["pt"]
        moved = p.placement.migrate_to("pt", WORLD, DEVS)
        out["moved_is_priced"] = moved == p.psub.priced_bytes(
            p.psub.price_migration(payload, WORLD))
        h = p.placement.route(A, "pt")
        out["close"] = bool(np.allclose(p.np(h.dot(x)), p.np(A.dot(x)),
                                        rtol=1e-5, atol=1e-5))
    finally:
        _reset(p)
    return out


@pytest.fixture(scope="module")
def placement_ranks(jax_mesh_cases):
    from legate_sparse_tpu_torch.parallel.launch import run_ranks
    from utils_test.torch_ops_ranks import placement_rank

    return run_ranks(placement_rank, WORLD, backend="gloo",
                     timeout=RANK_TIMEOUT, threads=1)


def test_build_submesh_fingerprint_stable(placement_ranks, jax_mesh_cases):
    """``::test_build_submesh_fingerprint_stable`` at 8 ranks: equal
    slices give the same mesh (one group a rank list and job), other
    slices other fingerprints, a one-device slice None, and a slice off
    the end the same ``ValueError``."""
    assert jax_mesh_cases["fp_equal"]
    for r in placement_ranks:
        f = r["fingerprint"]
        assert f["equal"] and f["same_mesh"] and f["differs"]
        assert f["single"] and "falls off" in f["falls"]


def test_migration_priced_equals_measured_and_swaps_version(
        placement_ranks, jax_mesh_cases):
    """``::test_migration_priced_equals_measured_and_swaps_version`` at 8
    ranks: priced == recorded bytes exactly on every rank, one
    migration's counters, the version swap with the old handle still
    serving, both bit for bit the unplaced product (the JAX package
    holds its product to 1e-5), and a re-place resetting."""
    assert jax_mesh_cases["moved_is_priced"] and jax_mesh_cases["close"]
    for r in placement_ranks:
        m = r["migration"]
        assert m["h0"] == (True, 0, True, True)
        assert m["moved"] == m["priced"]
        assert m["deltas"] == {
            "placement.migrations": 1, "placement.migration.bytes":
            m["moved"], "comm.dist_reshard.ppermute_bytes": m["moved"],
            "comm.dist_reshard.ppermute": 1}
        assert m["h1"] == (1, True, (0, WORLD), True, "cpu", True)
        assert m["replaced"] == (0, {})


def test_placed_product_no_collective_outside_slice(placement_ranks):
    """The port's isolation case: a tenant on a slice of ranks 0-1;
    ranks 2-7 hold no block and make no collective while serving its
    product, ranks 0-1 make theirs, and every rank returns the same bits,
    those of the unplaced product."""
    ys = set()
    for rank, r in enumerate(placement_ranks):
        i = r["isolation"]
        assert i["member"] == (rank < 2)
        assert (i["calls"] > 0) if rank < 2 else (i["calls"] == 0)
        assert i["bits"]
        ys.add(i["y"])
    assert len(ys) == 1


def test_breaker_degraded_placed_tenant_shrinks(placement_ranks):
    """``::test_breaker_degraded_placed_tenant_shrinks`` at 8 ranks."""
    for r in placement_ranks:
        b = r["breaker"]
        assert b["open"] == "open" and b["done"] and b["served"]
        assert b["shed"] == (True, "breaker")
        assert (b["degraded"], b["flagged"], b["flags"]) == (2, 1, ("pt",))
        assert b["decision"] == (True, "shrink")
        assert b["slice"] == (0, 2) and b["flags_after"] == ()


def test_controller_cooldown_and_thrash(placement_ranks, pkgs):
    """``::test_controller_cooldown_and_thrash`` at 8 ranks: the held and
    executed plans, the counters and the thrash signature; every rank's
    decisions equal, and each the JAX ``propose`` of the same snapshot
    where the controller did not hold it."""
    decisions = {repr(r["cooldown"]["decisions"]) for r in placement_ranks}
    assert len(decisions) == 1
    for r in placement_ranks:
        c = r["cooldown"]
        assert c["d1"] == (True, "burning", (0, WORLD))
        assert c["d2"] == (False, "cooldown")
        assert c["d3"] == (True, "shrink") and c["d4"] is True
        ctr = c["counters"]
        assert (ctr["placement.steps"], ctr["placement.proposals"],
                ctr["placement.migrations"], ctr["placement.hold.cooldown"],
                ctr["placement.thrash"]) == (3, 3, 2, 1, 1)
        assert c["thrash"] == 1
        assert c["watchdog"] is False, "no watchdog on a job of ranks"
    j = pkgs["jax"]
    d1 = placement_ranks[0]["cooldown"]["decisions"][0]
    hog = {"busy_ns": 8 * 10 ** 9, "qos": "interactive"}
    assert tuple(j.pctl.propose(j.snap(
        demand={"hog": hog}, qos_weights={"interactive": 8.0},
        burns={"interactive": 20.0},
        payload_bytes=placement_ranks[0]["cooldown"]["payload"]))) == d1


def test_controller_decision_agreed_across_ranks(placement_ranks):
    """The port's agreement case: each rank attributes a different load
    (its own queue waits); the ranks' local proposals differ, the
    controller's decision is one on every rank."""
    local = {r["agree"]["local"] for r in placement_ranks}
    agreed = {r["agree"]["agreed"] for r in placement_ranks}
    assert len(local) > 1
    assert len(agreed) == 1


def test_closed_loop_migration_drops_burn(placement_ranks):
    """``::test_closed_loop_migration_drops_burn`` at 8 ranks: a burning
    interactive SLO and skewed demand; the agreed step migrates the
    noisy tenant onto a submesh of 2+ ranks with the priced bytes
    recorded exactly, its requests then serve the unplaced bits, and the
    fast burn falls below the page threshold with no new breach.  The
    JAX test's 60 ms admission stall against the default 50 ms objective
    becomes 400 ms against a registered 300 ms one: on gloo a slice's
    collectives across rank processes on a loaded CPU can take 50 ms
    themselves."""
    from legate_sparse_tpu_torch.placement import controller as pctl

    for r in placement_ranks:
        c = r["closed_loop"]
        assert c["v1"][0] == "breach" and c["v1"][1] >= pctl.BURN_PAGE
        assert c["breach1"] == 1
        act, reason, moved_noisy, priced = c["decision"]
        assert (act, reason, moved_noisy) == (True, "burning", True)
        assert c["slices"]["noisy"][1] >= 2
        assert c["measured"] == priced > 0
        status, burn, total = c["v2"]
        assert total >= 8 and status != "breach" and burn < pctl.BURN_PAGE
        assert c["no_new_breach"] and c["bits"]


def test_chaos_drill_migration_mid_storm(placement_ranks):
    """``::test_chaos_drill_migration_mid_storm`` at 8 ranks: the good
    tenant placed on ranks 0-1, moved to 0-3 mid-storm; exactly-once,
    exact pricing and bitwise parity hold on every rank (a rank outside
    a slice serves through the unplaced product)."""
    for r in placement_ranks:
        d = r["drill"]
        assert d["ok"], d["violations"]
        assert d["migrations"] == 2 and d["submitted"] == 24
        good = d["per_tenant"]["good"]
        assert good == {"submitted": 12, "served": 12, "shed": 0,
                        "error": 0}
        assert d["per_tenant"]["storm"]["shed"] >= 1
        assert d["deltas"] == {"placement.migrations": 2,
                               "comm.dist_reshard.ppermute": 2}
        assert d["slice"] == (0, 4) and not d["armed"]
