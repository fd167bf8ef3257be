# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Chaos drill harness: composed random faults under multi-tenant load
(the port of ``legate_sparse_tpu/resilience/chaos.py``).

Single-fault drills prove each mechanism in isolation; what they cannot
prove is *composition* — that a tenant's injected faults, breaker trips
and deadline storms stay contained while OTHER tenants' traffic flows
through the same gateway and engine.  :func:`run_drill` drives exactly
that and checks the gateway's isolation contract as hard invariants:

1. **Exactly-once resolution** — every submitted Future resolves (never
   hangs) with a typed outcome: a result tensor or an
   ``outcomes.Rejected``; an exception surfacing to a caller is a
   violation.
2. **Exact accounting** — per-tenant and global ``gateway.*`` counter
   deltas balance: ``submitted == served + shed + error`` for every
   tenant, and the global roll-ups agree with the per-tenant sums.
3. **Bitwise parity** — every served result equals, bit for bit, one
   of the legitimate clean dispatch paths, computed with all faults
   cleared: the plain ``A.dot`` (the inline route), the engine's
   bucketed plan, or a pinned version of a mutated tenant.

The fault schedule is drawn from a seeded ``random.Random`` over the
closed site catalog — the JAX package's draws in its order, so one seed
arms the same sites, kinds and counts in both packages.  Faults are
cleared between rounds and the policy registry is reset at the end.

Scenarios:

- ``device_loss=`` — a seeded ``device_loss`` at the CG fetch cadence
  and a checkpointed ``dist_cg`` through the recovery ladder each round.
  Every rank of the job runs the drill (SPMD), each with its own
  gateway; the rank drawn as lost leaves that solve with ``DeviceLost``,
  which its report counts as the expected outcome (``lost``), not as a
  violation; the survivors are held to the recovery accounting and to
  scipy's solution.
- ``mutation=`` — the serve-while-mutating drill on the delta layer.
- ``migration=`` — a placed tenant live-migrated mid-storm (needs
  ``settings.placement``).  On a job of several ranks every rank runs
  the drill with the same seed and applies the same migrations; a rank
  outside the tenant's slice serves it through the plain local product
  (``placement.migrate``).

Requires ``settings.gateway`` and ``settings.resil`` on.
"""

from __future__ import annotations

import random
from concurrent.futures import TimeoutError as _FutTimeoutError
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs as _obs
from ..settings import settings as _settings
from . import deadline as _deadline
from . import faults as _faults
from . import policy as _policy
from .outcomes import DeviceLost, Rejected

#: Default fault-site pool: the two gateway sites plus the engine sites
#: a gateway dispatch can reach.
DEFAULT_SITES = ("gateway.admit", "gateway.dispatch",
                 "engine.exec.dispatch", "engine.plan.build")

#: Fault kinds composed by default.  ``nonfinite`` is excluded: the
#: gateway sites carry no value for it to poison.
DEFAULT_KINDS = ("error", "latency")


@dataclass
class ChaosReport:
    """Outcome ledger of one drill (violations empty == contract held).
    ``lost`` counts the device-loss solves this rank left as the lost
    rank (SPMD drills only)."""

    rounds: int = 0
    submitted: int = 0
    served: int = 0
    shed: int = 0
    errors: int = 0
    faults_armed: int = 0
    faults_fired: int = 0
    recoveries: int = 0
    lost: int = 0
    migrations: int = 0
    mutations: int = 0
    compactions: int = 0
    per_tenant: Dict[str, Dict[str, int]] = field(default_factory=dict)
    violations: List[str] = field(default_factory=list)

    def ok(self) -> bool:
        return not self.violations


def _arm_random_faults(rng: random.Random, sites: Sequence[str],
                       kinds: Sequence[str],
                       report: ChaosReport) -> None:
    """Arm 1-2 faults for this round, drawn deterministically from
    ``rng`` (sites may repeat across rounds — re-arming replaces)."""
    for _ in range(rng.randint(1, 2)):
        site = rng.choice(list(sites))
        kind = rng.choice(list(kinds))
        _faults.inject(site, kind=kind, count=rng.randint(1, 3),
                       latency_ms=1.0)
        report.faults_armed += 1


def _run_device_loss_scenario(rng: random.Random, spec: dict,
                              report: ChaosReport) -> None:
    """One seeded device-loss recovery solve under the in-flight gateway
    load: arm a ``device_loss`` at the CG fetch cadence (the lost
    ordinal drawn from the drill's RNG), run a checkpointed ``dist_cg``,
    and hold it to three invariants on the survivors:

    1. **Exactly-once resolution** — the solve returns one value (the
       lost rank alone leaves it, with ``DeviceLost``).
    2. **Exact accounting** — one recovery's worth of
       ``resil.recovery.*``/``resil.ckpt.restores`` movement, and a
       nonzero reshard byte count.
    3. **Parity with scipy** — the recovered solution matches
       ``scipy.sparse.linalg.spsolve`` of the kept source within the
       drill's tolerance.

    The spec's matrix must need more than ``2 * conv_test_iters``
    iterations, so a checkpoint lands before the loss fires."""
    import scipy.sparse as _sp
    import scipy.sparse.linalg as _spla

    from ..parallel.dist_csr import dist_cg
    from ..utils import to_numpy
    from . import checkpoint as _ckpt

    A = spec["A"]
    b = np.asarray(spec["b"])
    rtol = float(spec.get("rtol", 1e-8))
    cti = int(spec.get("conv_test_iters", 5))
    every = int(spec.get("ckpt_iters", cti))
    device = rng.randrange(int(A.num_shards))
    c0 = _obs.counters.snapshot("resil.")
    _faults.inject("solver.cg.conv", "device_loss",
                   after=int(spec.get("after", 2)), device=device)
    try:
        with _ckpt.scope("chaos.device_loss", every=every):
            x, _iters = dist_cg(A, b, rtol=rtol, conv_test_iters=cti)
    except DeviceLost as e:
        if int(e.device) == device and A.shard == device:
            report.lost += 1            # this rank is the one lost
        else:
            report.violations.append(
                f"device_loss solve raised on a survivor: {e!r}")
        return
    except BaseException as e:  # noqa: BLE001 - ledger
        report.violations.append(
            f"device_loss solve raised instead of recovering: {e!r}")
        return
    report.recoveries += 1
    c1 = _obs.counters.snapshot("resil.")

    def delta(name: str) -> int:
        return int(c1.get(name, 0)) - int(c0.get(name, 0))

    for name, want in (("resil.recovery.attempts", 1),
                       ("resil.recovery.device_loss", 1),
                       ("resil.recovery.mesh_shrink", 1),
                       ("resil.recovery.succeeded", 1),
                       ("resil.ckpt.restores", 1)):
        if delta(name) != want:
            report.violations.append(
                f"device_loss accounting: {name} moved {delta(name)} "
                f"!= {want}")
    if delta("resil.recovery.reshard_bytes") <= 0:
        report.violations.append(
            "device_loss: survivor reshard ledgered zero bytes")
    src = A._src_csr
    if src is None:
        report.violations.append(
            "device_loss: matrix retains no source for the parity "
            "reference (shard via shard_csr)")
        return
    S = _sp.csr_matrix((to_numpy(src.data), to_numpy(src.indices),
                        to_numpy(src.indptr)), shape=src.shape)
    ref = _spla.spsolve(S.tocsc(), b)
    got = to_numpy(x.full_tensor())
    if not np.allclose(got, ref, rtol=1e-5,
                       atol=float(spec.get("parity_atol", 1e-6))):
        report.violations.append(
            "device_loss: recovered solution diverged from the scipy "
            "reference")


def _setup_migration_scenario(spec: dict, tenants: Sequence[dict],
                              placed_refs: Dict[str, List],
                              report: ChaosReport) -> dict:
    """Arm the live-migration scenario before the first round: place
    the target tenant's matrix and carve it onto its ``before`` slice
    so the mid-storm migration has a placement to move off of.  The
    pre-migration handle is pinned as a parity reference."""
    from .. import placement as _placement

    name = str(spec["tenant"])
    spec_t = next((t for t in tenants if str(t["name"]) == name), None)
    if spec_t is None:
        raise ValueError(
            f"chaos migration scenario: tenant {name!r} is not in the "
            f"drill tenant list")
    before, after = (int(spec["devices"][0]), int(spec["devices"][1]))
    A = spec_t["A"]
    _placement.place(name, A)
    _placement.migrate_to(name, before)
    report.migrations += 1
    placed_refs[name] = [_placement.route(A, name)]
    return {"tenant": name, "A": A, "after": after,
            "payload": _placement.registry().payload_bytes()[name]}


def _run_migration_scenario(state: dict,
                            placed_refs: Dict[str, List],
                            report: ChaosReport) -> None:
    """Fire one live migration while the round's gateway submissions
    are in flight, and hold it to the placement invariants:

    1. **Exactly-once execution** — exactly one migration's worth of
       ``placement.migration.*`` counter movement.
    2. **Exact pricing** — the recorded ``comm.dist_reshard.*`` bytes
       equal the ``price_migration`` prediction (one predictor on
       both sides, so the equality is exact).
    3. **Version drain** — requests admitted before the swap drain on
       the old placement; the post-migration handle joins the parity
       reference set, so every served value must still match a clean
       dispatch on whichever placement served it."""
    from .. import placement as _placement
    from ..placement import submesh as _submesh

    c0p = _obs.counters.snapshot("placement.")
    c0r = _obs.counters.snapshot("comm.dist_reshard.")
    moved = _placement.migrate_to(state["tenant"], state["after"])
    report.migrations += 1
    c1p = _obs.counters.snapshot("placement.")
    c1r = _obs.counters.snapshot("comm.dist_reshard.")

    def delta(c0, c1, name: str) -> int:
        return int(c1.get(name, 0)) - int(c0.get(name, 0))

    priced = _submesh.priced_bytes(_submesh.price_migration(
        state["payload"], state["after"]))
    if delta(c0p, c1p, "placement.migrations") != 1:
        report.violations.append(
            f"migration accounting: placement.migrations moved "
            f"{delta(c0p, c1p, 'placement.migrations')} != 1")
    if delta(c0p, c1p, "placement.migration.bytes") != moved:
        report.violations.append(
            f"migration accounting: placement.migration.bytes moved "
            f"{delta(c0p, c1p, 'placement.migration.bytes')} != "
            f"{moved} returned")
    if delta(c0r, c1r, "comm.dist_reshard.ppermute") != 1:
        report.violations.append(
            f"migration accounting: comm.dist_reshard.ppermute moved "
            f"{delta(c0r, c1r, 'comm.dist_reshard.ppermute')} != 1")
    if delta(c0r, c1r, "comm.dist_reshard.ppermute_bytes") != priced:
        report.violations.append(
            f"migration pricing: comm.dist_reshard.ppermute_bytes "
            f"moved {delta(c0r, c1r, 'comm.dist_reshard.ppermute_bytes')}"
            f" != priced {priced}")
    if moved != priced:
        report.violations.append(
            f"migration pricing: recorded {moved} bytes != priced "
            f"{priced}")
    placed_refs[state["tenant"]].append(
        _placement.route(state["A"], state["tenant"]))


def _setup_mutation_scenario(spec: dict, tenants: Sequence[dict],
                             placed_refs: Dict[str, List],
                             report: ChaosReport) -> dict:
    """Arm the serve-while-mutating scenario before the first round:
    wrap the target tenant's matrix in a :class:`~..delta.DeltaCSR` so
    every later submission routes through versioned delta serving, and
    pin the pristine v0 view as the first parity reference."""
    from ..delta import DeltaCSR

    name = str(spec["tenant"])
    spec_t = next((t for t in tenants if str(t["name"]) == name), None)
    if spec_t is None:
        raise ValueError(
            f"chaos mutation scenario: tenant {name!r} is not in the "
            f"drill tenant list")
    A = spec_t["A"]
    D = DeltaCSR(A, capacity=spec.get("capacity"))
    spec_t["A"] = D
    placed_refs[name] = [D.view()]
    return {"tenant": name, "delta": D, "base": A,
            "updates": int(spec.get("updates", 100)),
            "batch": int(spec.get("batch", 10)),
            "seed": int(spec.get("seed", 0))}


def _run_mutation_scenario(state: dict,
                           placed_refs: Dict[str, List],
                           report: ChaosReport) -> None:
    """Stream the seeded update storm into the served matrix and fire
    one compaction with an atomic version swap while the round's gateway
    submissions are in flight.  Invariants held:

    1. **Exactly-once resolution** — ``delta.*`` counter movement is
       exactly the independently kept applied/overwrite/merge counts of
       the seeded stream.
    2. **Version drain** — every intermediate view (one per update
       batch) and the post-compaction view join the parity reference
       set, so every served value must equal bit for bit a clean
       dispatch on whichever version served it.
    3. **Compaction = cold rebuild** — the swapped-in base is bit for
       bit the COO rebuild of base entries + resolved stream."""
    import torch

    from ..gallery import mutation_stream

    D = state["delta"]
    name = state["tenant"]
    c0 = _obs.counters.snapshot("delta.")
    expected: Dict[Tuple[int, int], float] = {}
    exp_batches = exp_applied = exp_over = 0
    for rows, cols, vals in mutation_stream(
            state["seed"], state["base"], state["updates"],
            batch=state["batch"]):
        batch_seen = set()
        for r, c, v in zip(rows, cols, vals):
            key = (int(r), int(c))
            if key in expected or key in batch_seen:
                exp_over += 1
            else:
                exp_applied += 1
            batch_seen.add(key)
            expected[key] = float(v)
        D.update(rows, cols, vals)
        exp_batches += 1
        report.mutations += 1
        # Each batch publishes a fresh view; a request admitted between
        # batches legitimately drains on it.
        placed_refs[name].append(D.view())
    pending = D.pending
    merged = D.compact()
    report.compactions += 1
    placed_refs[name].append(D.view())
    c1 = _obs.counters.snapshot("delta.")

    def delta(cname: str) -> int:
        return int(c1.get(cname, 0)) - int(c0.get(cname, 0))

    for cname, want in (("delta.updates", exp_batches),
                        ("delta.applied", exp_applied),
                        ("delta.overwrites", exp_over),
                        ("delta.compactions", 1),
                        ("delta.swap.versions", 1),
                        ("delta.compaction.merged", merged)):
        if delta(cname) != want:
            report.violations.append(
                f"mutation accounting: {cname} moved {delta(cname)} "
                f"!= {want}")
    if merged != pending:
        report.violations.append(
            f"mutation accounting: compaction merged {merged} != "
            f"{pending} pending")
    if D.pending != 0:
        report.violations.append(
            f"mutation: {D.pending} updates survived compaction")
    # The swapped-in base against a cold COO rebuild of the mutated
    # matrix, bit for bit (independent bookkeeping on both sides).
    cold = _cold_rebuild(state["base"], expected)
    nb = D.view().base
    same = (nb.nnz == cold.nnz
            and torch.equal(nb.data, cold.data)
            and torch.equal(nb.indices.to(torch.int64),
                            cold.indices.to(torch.int64))
            and torch.equal(nb.indptr.to(torch.int64),
                            cold.indptr.to(torch.int64)))
    if not same:
        report.violations.append(
            "mutation: compacted base != cold rebuild of the mutated "
            "matrix (bitwise)")


def _cold_rebuild(base, expected: Dict[Tuple[int, int], float]):
    """``base``'s stored entries with the ``expected`` targets applied
    (a nonzero target overwrites or inserts, 0.0 deletes), through the
    COO constructor: the JAX package's dictionary merge, in numpy over
    the linear keys so it scales to a matrix of 10^8 entries."""
    from ..csr import csr_array
    from ..utils import to_numpy

    rows, cols, data = (to_numpy(a) for a in base._coo_parts())
    n_cols = base.shape[1]
    key = rows.astype(np.int64) * n_cols + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key, val = key[order], data[order].copy()
    tk = np.asarray([r * n_cols + c for r, c in sorted(expected)],
                    dtype=np.int64)
    tv = np.asarray([expected[k] for k in sorted(expected)],
                    dtype=np.float64)
    pos = np.searchsorted(key, tk)
    hit = (pos < key.size) & (key[np.minimum(pos, key.size - 1)] == tk)
    val[pos[hit]] = tv[hit].astype(val.dtype)
    keep = np.ones(key.size, dtype=bool)
    keep[pos[hit & (tv == 0.0)]] = False
    key, val = key[keep], val[keep]
    ins = ~hit & (tv != 0.0)
    at = np.searchsorted(key, tk[ins])
    key = np.insert(key, at, tk[ins])
    val = np.insert(val, at, tv[ins].astype(val.dtype))
    return csr_array((val, (key // n_cols, key % n_cols)), shape=base.shape,
                     dtype=base.dtype, device=base.device)


def _same(out, ref) -> bool:
    import torch

    return (isinstance(ref, torch.Tensor) and out.shape == ref.shape
            and out.dtype == ref.dtype and torch.equal(out, ref))


def run_drill(gateway, tenants: Sequence[dict], *, rounds: int = 4,
              seed: int = 0,
              sites: Sequence[str] = DEFAULT_SITES,
              kinds: Sequence[str] = DEFAULT_KINDS,
              result_timeout_s: float = 30.0,
              device_loss: Optional[dict] = None,
              migration: Optional[dict] = None,
              mutation: Optional[dict] = None) -> ChaosReport:
    """Run ``rounds`` of composed-fault multi-tenant load through
    ``gateway`` and verify the isolation invariants (module docstring).

    Each tenant spec is a dict: ``name``, ``qos``, ``A`` (the tenant's
    matrix), ``xs`` (operand vectors submitted each round), and optional
    ``deadline_ms`` — when set, that tenant's submissions run inside
    ``deadline.scope(deadline_ms)`` (``0.0`` = a deadline storm: every
    request arrives already expired).

    ``device_loss`` opts a recovery scenario into every round (see
    :func:`_run_device_loss_scenario`): ``A`` (a ``shard_csr`` matrix),
    ``b``, and optional ``rtol`` / ``conv_test_iters`` / ``ckpt_iters``
    / ``after`` / ``parity_atol``.  Every rank of the job must run the
    drill with the same seed.

    ``mutation`` (needs ``settings.delta``): a drill ``tenant`` plus
    optional ``updates`` (default 100), ``batch``, ``seed`` and
    ``capacity``; at the midpoint round the seeded update storm streams
    in and a compaction fires (:func:`_run_mutation_scenario`).

    ``migration`` (needs ``settings.placement``): a drill ``tenant`` (a
    square-matrix one) and its ``devices = (before, after)`` slice
    widths.  The tenant is placed on its ``before`` slice up front; at
    the midpoint round, while that round's submissions are in flight,
    it live-migrates to ``after`` — held to exactly-once / exact-pricing
    invariants (:func:`_run_migration_scenario`), with both placement
    versions' handles joining the tenant's parity reference set."""
    if not (_settings.gateway and _settings.resil):
        raise RuntimeError(
            "chaos.run_drill needs settings.gateway and settings.resil "
            "on — the drill composes faults through the armed system")
    if migration is not None and not _settings.placement:
        raise RuntimeError(
            "chaos.run_drill migration scenario needs "
            "settings.placement on — there is no live placement to "
            "migrate otherwise")
    if mutation is not None and not _settings.delta:
        raise RuntimeError(
            "chaos.run_drill mutation scenario needs settings.delta "
            "on — there is no delta layer to mutate otherwise")
    rng = random.Random(seed)
    report = ChaosReport(rounds=rounds)
    placed_refs: Dict[str, List] = {}
    mig_state: Optional[dict] = None
    if migration is not None:
        mig_state = _setup_migration_scenario(migration, tenants,
                                              placed_refs, report)
    mut_state: Optional[dict] = None
    if mutation is not None:
        mut_state = _setup_mutation_scenario(mutation, tenants,
                                             placed_refs, report)
    c0 = _obs.counters.snapshot("gateway.")
    names = [str(spec["name"]) for spec in tenants]
    try:
        for _round in range(rounds):
            _faults.clear()
            _arm_random_faults(rng, sites, kinds, report)
            inflight: List[Tuple[dict, object, object]] = []
            for spec in tenants:
                dl: Optional[float] = spec.get("deadline_ms")
                for x in spec["xs"]:
                    if dl is not None:
                        with _deadline.scope(dl):
                            fut = gateway.submit(
                                spec["A"], x, tenant=spec["name"],
                                qos=spec.get("qos", "batch"))
                    else:
                        fut = gateway.submit(
                            spec["A"], x, tenant=spec["name"],
                            qos=spec.get("qos", "batch"))
                    report.submitted += 1
                    inflight.append((spec, x, fut))
            if device_loss is not None:
                # The recovery solve runs while this round's gateway
                # submissions are still queued — live load.
                _run_device_loss_scenario(rng, device_loss, report)
            if mig_state is not None and _round == rounds // 2:
                # The live migration mid-storm: this round's admitted
                # requests hold handles pinned at admission and drain
                # on the old placement.
                _run_migration_scenario(mig_state, placed_refs, report)
            if mut_state is not None and _round == rounds // 2:
                # The update storm and compaction mid-storm: the
                # round's admitted requests hold views pinned at
                # admission and drain on the pre-mutation version.
                _run_mutation_scenario(mut_state, placed_refs, report)
            gateway.flush()
            report.faults_fired += sum(
                a["fired"] for a in _faults.armed().values())
            # Quiesce injection BEFORE computing parity references: the
            # reference dispatch must be clean.
            _faults.clear()
            for spec, x, fut in inflight:
                try:
                    out = fut.result(timeout=result_timeout_s)
                except (_FutTimeoutError, TimeoutError):
                    report.violations.append(
                        f"hang: tenant {spec['name']} future never "
                        f"resolved")
                    continue
                except BaseException as e:  # noqa: BLE001 - ledger
                    report.errors += 1
                    report.violations.append(
                        f"exception surfaced to tenant "
                        f"{spec['name']}: {e!r}")
                    continue
                if isinstance(out, Rejected):
                    report.shed += 1
                    if out.reason not in (
                            "deadline_shed", "quota", "queue_full",
                            "breaker"):
                        report.violations.append(
                            f"untyped rejection reason {out.reason!r}")
                    continue
                report.served += 1
                refs = [spec["A"].dot(x)]
                for h in placed_refs.get(str(spec["name"]), ()):
                    refs.append(h.dot(x))
                eng = getattr(gateway, "_engine", None)
                if eng is not None:
                    y_eng = eng.matvec(spec["A"], x)
                    if y_eng is not None:
                        refs.append(y_eng)
                if not any(_same(out, r) for r in refs):
                    report.violations.append(
                        f"bitwise parity violated for tenant "
                        f"{spec['name']}")
    finally:
        _faults.clear()
        _policy.reset()
    # ---- exact accounting over the counter deltas ----
    c1 = _obs.counters.snapshot("gateway.")

    def delta(name: str) -> int:
        return int(c1.get(name, 0)) - int(c0.get(name, 0))

    if delta("gateway.submitted") != report.submitted:
        report.violations.append(
            f"gateway.submitted moved {delta('gateway.submitted')} "
            f"!= {report.submitted} submitted")
    tot_served = tot_shed = tot_err = 0
    for name in names:
        sub = delta(f"gateway.tenant.{name}.submitted")
        srv = delta(f"gateway.tenant.{name}.served")
        shd = delta(f"gateway.tenant.{name}.shed")
        err = delta(f"gateway.tenant.{name}.error")
        report.per_tenant[name] = {
            "submitted": sub, "served": srv, "shed": shd, "error": err}
        tot_served += srv
        tot_shed += shd
        tot_err += err
        if sub != srv + shd + err:
            report.violations.append(
                f"tenant {name} ledger leak: submitted {sub} != "
                f"served {srv} + shed {shd} + error {err}")
    if tot_served != report.served:
        report.violations.append(
            f"served roll-up {tot_served} != observed {report.served}")
    if tot_shed != report.shed:
        report.violations.append(
            f"shed roll-up {tot_shed} != observed {report.shed}")
    reasons = sum(delta(f"gateway.rejected.{r}")
                  for r in ("deadline_shed", "quota", "queue_full",
                            "breaker"))
    if reasons != tot_shed:
        report.violations.append(
            f"per-reason rejections {reasons} != tenant shed sum "
            f"{tot_shed}")
    return report
