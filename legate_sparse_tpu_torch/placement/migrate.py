# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Live migration behind the gateway (the port of
``legate_sparse_tpu/placement/migrate.py``, docs/PLACEMENT.md).

The actuator half of the placement loop: a process-global registry of
**placed tenant matrices**, each an immutable source ``csr_array``
plus a versioned current placement (a :class:`~legate_sparse_tpu_torch.
parallel.dist_csr.DistCSR` on the tenant's submesh, or ``None`` for a
single-device slice / not-yet-carved tenant — those serve through the
plain local kernels).

SPMD: every rank of a job registers the same tenants with the same
matrices and applies the same migrations in the same order (the
controller agrees its decision, ``controller.py``).  A rank inside a
tenant's slice holds its block of the tenant's ``DistCSR`` and serves
through ``dist_spmv`` over the slice's ranks only; a rank outside the
slice holds no block and serves that tenant's requests through the
plain local product of its own copy of the source, with no collective,
so the slice's collectives never wait on it.  Every rank returns the
same ``y``, bit for bit the unplaced product.

Routing contract (``engine/gateway.py``): every armed admission for a
registered tenant swaps the submitted matrix for a
:class:`PlacedHandle` **pinning the placement version current at
admission**.  A migration builds the new placement, records its priced
``comm.dist_reshard.*`` volume, then atomically swaps the registry
entry — in-flight requests drain on the old placement through their
pinned handles while new admissions route to the new one.  Nothing is
torn down mid-request and no request observes a half-moved matrix.

Breaker-degraded mode: when the gateway's dispatch breaker is open, a
placed tenant's traffic keeps serving through its own submesh (inline,
off the broken shared path) and the tenant is flagged for a slice
**shrink** — the controller's next step halves its slice instead of
the gateway shedding every deferrable class globally.

Inert by default: nothing here is reachable without
``LEGATE_SPARSE_TPU_PLACEMENT`` (the gateway's routing hook is one
flag read), and no ``placement.*`` counter moves while it is off.

Counters / events / histograms (docs/OBSERVABILITY.md):

- ``placement.placed`` / ``placement.routes`` /
  ``placement.migrations`` / ``placement.migration.bytes`` /
  ``placement.degraded_serve`` / ``placement.shrink.flagged``
- events ``placement.place`` / ``placement.migration``
- histogram ``lat.placement.migration``
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from ..obs import comm as _comm
from ..obs import counters as _counters
from ..obs import latency as _latency
from ..obs import trace as _trace
from ..obs import attrib as _attrib
from ..parallel.mesh import mesh_ranks
from . import submesh as _submesh

__all__ = [
    "PlacedHandle", "PlacementRegistry", "registry", "place", "route",
    "is_placed_handle", "flag_shrink", "migrate_to", "reset",
]


class PlacedHandle:
    """A tenant request's pinned view of its placed matrix: the
    version current at admission.  Quacks enough like ``csr_array``
    for the gateway (shape/nnz/dtype/dot) while deliberately failing
    the engine's ``isinstance`` eligibility gate — placed traffic
    serves inline through its OWN submesh, never through the shared
    engine path it was migrated off of."""

    __slots__ = ("tenant", "version", "_src", "_dist")

    def __init__(self, tenant: str, src, dist, version: int):
        self.tenant = tenant
        self.version = int(version)
        self._src = src
        self._dist = dist

    @property
    def shape(self):
        return self._src.shape

    @property
    def nnz(self):
        return self._src.nnz

    @property
    def dtype(self):
        return self._src.dtype

    def dot(self, x):
        """Serve one SpMV on the pinned placement: the tenant's
        submesh ``dist_spmv`` (comm ledgered + attributed under the
        caller's trace context), gathered over the slice's ranks into
        a tensor on this rank's device; or the plain local kernel for a
        single-device / not-yet-carved placement and on a rank outside
        the slice."""
        if self._dist is None:
            return self._src.dot(x)
        from ..parallel.dist_csr import dist_spmv, shard_vector

        xs = shard_vector(x, self._dist.mesh, self._dist.rows_padded)
        y = dist_spmv(self._dist, xs)
        return y.full_tensor()[: self._src.shape[0]]

    def __repr__(self):  # pragma: no cover - debugging aid
        fp = "local" if self._dist is None else "dist"
        return (f"PlacedHandle(tenant={self.tenant!r}, "
                f"v{self.version}, {fp})")


class _Entry:
    __slots__ = ("tenant", "src", "dist", "slice", "version",
                 "payload_bytes")

    def __init__(self, tenant: str, src, payload: int):
        self.tenant = tenant
        self.src = src
        self.dist = None
        self.slice: Optional[Tuple[int, int]] = None
        self.version = 0
        self.payload_bytes = int(payload)


class PlacementRegistry:
    """Process-global placed-tenant ledger (one instance via
    :func:`registry`); all mutation under one lock, handles pin
    immutable (src, dist, version) triples so readers never lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._items: Dict[str, _Entry] = {}
        self._shrink: set = set()

    # ---------------- registration / routing ----------------

    def place(self, tenant: str, A) -> None:
        """Register ``A`` as tenant's placed matrix (square CSR — the
        served operand and result live on the same row partition).
        Until the controller carves a slice the tenant serves on the
        plain local path; re-placing replaces the source and resets
        the placement."""
        rows, cols = A.shape
        if rows != cols:
            raise ValueError(
                f"placement.place: matrix must be square for submesh "
                f"serving (got {A.shape}); rectangular operators keep "
                f"the shared global mesh")
        tenant = str(tenant)
        with self._lock:
            self._items[tenant] = _Entry(
                tenant, A, _submesh.payload_bytes(A))
            self._shrink.discard(tenant)
        _counters.inc("placement.placed")
        _trace.event("placement.place", tenant=tenant,
                     payload_bytes=_submesh.payload_bytes(A))

    def route(self, A, tenant: str):
        """Admission-time routing: swap a registered tenant's own
        matrix for a handle pinning the current placement version;
        any other (tenant, matrix) pair passes through untouched."""
        e = self._items.get(str(tenant))
        if e is None or e.src is not A:
            return A
        with self._lock:
            handle = PlacedHandle(e.tenant, e.src, e.dist, e.version)
        _counters.inc("placement.routes")
        return handle

    # ---------------- controller-facing snapshot ----------------

    def slices(self) -> Dict[str, Tuple[int, int]]:
        with self._lock:
            return {t: e.slice for t, e in self._items.items()
                    if e.slice is not None}

    def payload_bytes(self) -> Dict[str, int]:
        with self._lock:
            return {t: e.payload_bytes for t, e in self._items.items()}

    def tenants(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._items))

    def version(self, tenant: str) -> Optional[int]:
        e = self._items.get(str(tenant))
        return None if e is None else e.version

    def flag_shrink(self, tenant: str) -> bool:
        """Mark a misbehaving placed tenant for a slice shrink at the
        controller's next step (breaker-degraded mode).  Idempotent:
        the flag (and its counter) moves once until acted on."""
        tenant = str(tenant)
        with self._lock:
            if tenant not in self._items or tenant in self._shrink:
                return False
            self._shrink.add(tenant)
        _counters.inc("placement.shrink.flagged")
        return True

    def shrink_flagged(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._shrink))

    # ---------------- migration ----------------

    def migrate(self, tenant: str, dst: Tuple[int, int],
                devices: Sequence) -> int:
        """Live-migrate one tenant onto slice ``dst = (start, count)``
        of the flat ``devices`` order.  Builds the new placement
        on the slice's ranks (``reshard()`` where this rank holds a
        block already, ``shard_csr`` of the source for a first carve or
        a rank joining the slice; a rank outside the slice holds none),
        records the priced ``comm.dist_reshard.*`` volume attributed to
        the tenant, then atomically swaps the entry — in-flight pinned
        handles keep the old placement alive until they drain.  Returns
        the recorded bytes.  Every rank of the job calls it with the
        same arguments (building the slice's group is a collective of
        the job); each rank's ledger records the migration once."""
        tenant = str(tenant)
        e = self._items.get(tenant)
        if e is None:
            raise KeyError(f"placement.migrate: tenant {tenant!r} is "
                           f"not placed")
        t0 = time.perf_counter_ns()
        start, count = int(dst[0]), int(dst[1])
        mesh = _submesh.build_submesh(devices, start, count)
        if mesh is None or _submesh.this_rank() not in mesh_ranks(mesh):
            new_dist = None
        elif e.dist is not None:
            from ..parallel.reshard import reshard as _reshard

            new_dist = _reshard(e.dist, mesh=mesh)
        else:
            from ..parallel.dist_csr import shard_csr

            new_dist = shard_csr(e.src, mesh=mesh)
        # The migration's interconnect volume is DECLARED through the
        # same reshard_volumes predictor the controller priced with —
        # priced == measured by construction.
        vols = _submesh.price_migration(e.payload_bytes, count)
        with _attrib.scope(((tenant, None),)):
            moved = _comm.record("dist_reshard", vols,
                                 calls={"ppermute": 1}, layout="1d-row")
        with self._lock:
            e.dist = new_dist
            e.slice = (start, count)
            e.version += 1
            self._shrink.discard(tenant)
            version = e.version
        _counters.inc("placement.migrations")
        _counters.handle("placement.migration.bytes").inc(int(moved))
        _latency.observe("lat.placement.migration",
                         (time.perf_counter_ns() - t0) / 1e6)
        _trace.event("placement.migration", tenant=tenant,
                     start=start, devices=count, bytes=int(moved),
                     version=version)
        return int(moved)

    def apply(self, moves: Dict[str, Tuple[int, int]],
              devices: Sequence) -> int:
        """Execute a decision's moves in sorted tenant order; returns
        the total recorded migration bytes."""
        total = 0
        for tenant in sorted(moves):
            total += self.migrate(tenant, moves[tenant], devices)
        return total

    def reset(self) -> None:
        with self._lock:
            self._items.clear()
            self._shrink.clear()


_REGISTRY = PlacementRegistry()


def registry() -> PlacementRegistry:
    return _REGISTRY


def place(tenant: str, A) -> None:
    _REGISTRY.place(tenant, A)


def route(A, tenant: str):
    return _REGISTRY.route(A, tenant)


def is_placed_handle(A) -> bool:
    return isinstance(A, PlacedHandle)


def flag_shrink(tenant: str) -> bool:
    return _REGISTRY.flag_shrink(tenant)


def migrate_to(tenant: str, count: int,
               devices: Optional[Sequence] = None, *,
               start: int = 0) -> int:
    """Force one tenant onto slice ``(start, count)`` of the flat
    device order (the job's ranks by default) — the chaos drill's
    deterministic mid-storm migration trigger (the controller path
    goes through ``PlacementController.step``).  Every rank calls it."""
    if devices is None:
        devices = _submesh.job_ranks()
    return _REGISTRY.migrate(tenant, (int(start), int(count)), devices)


def reset() -> None:
    """Test isolation: drop every placed tenant and shrink flag."""
    _REGISTRY.reset()
