# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Per-tenant submesh carving (the port of
``legate_sparse_tpu/placement/submesh.py``, docs/PLACEMENT.md).

Pure functions turning a
:func:`~legate_sparse_tpu_torch.obs.capacity.recommend` advisory sizing
into a concrete, deterministic partition of the flat global device
order.  In the port a device is a rank of the job (each rank drives one
card), so the flat order is the ranks ``0..world-1``:

- :func:`feasible_allocation` clamps a (possibly undersized)
  recommendation onto the physical device count;
- :func:`carve` assigns each allocated tenant a **contiguous** slice
  ``(start, count)`` of the flat device list, tenants in sorted-name
  order — same allocation in, same slices out, always;
- :func:`build_submesh` materializes a slice as a 1d-row mesh over
  exactly those ranks (``parallel.mesh.row_submesh``).

Invariants (pinned by tests/test_torch_placement.py):

1. **Contiguity / disjointness** — slices never overlap and cover a
   prefix of the flat device order, so neighbor tenants share no
   device (the isolation the controller is buying).
2. **Fingerprint stability** — carving the same allocation over the
   same device list twice builds meshes with equal
   ``mesh_fingerprint``s: the meshes are cached per rank list, so the
   same slice is the same mesh and its process group is created once
   per job, never once per controller epoch; an unchanged tenant
   re-resolves to the *same* plan keys, so "no move" costs nothing.
3. **Purity** — nothing here reads a clock, a counter, or settings;
   :func:`~legate_sparse_tpu_torch.placement.controller.propose` composes
   these under its own purity contract.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ..obs import comm as _comm

__all__ = [
    "feasible_allocation", "carve", "build_submesh", "payload_bytes",
    "price_migration", "priced_bytes", "job_ranks", "this_rank",
]


def job_ranks() -> list:
    """The flat device order of this job: its ranks ``0..world-1``
    (``[0]`` for a process outside any process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def this_rank() -> int:
    """This process's rank (0 outside any process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def feasible_allocation(recommendation: Dict[str, object],
                        devices: int) -> Dict[str, int]:
    """Clamp a ``capacity.recommend`` result onto ``devices`` physical
    devices.  The advisory layer may legitimately overshoot (every
    burning tenant ceils — that IS its undersized signal); a carve
    cannot.  Deterministic trim rule: one device at a time from the
    largest allocation above 1 (ties by tenant name); if every tenant
    is already at 1 and the mesh still overflows, the
    smallest-share tenants (ties by name, reversed) drop out of the
    allocation entirely and stay on their current placement."""
    devices = max(1, int(devices))
    tenants = recommendation.get("tenants", {}) or {}
    alloc = {t: max(1, int(rec["devices"]))
             for t, rec in sorted(tenants.items())}
    overshoot = sum(alloc.values()) - devices
    while overshoot > 0:
        victims = sorted((t for t, n in alloc.items() if n > 1),
                         key=lambda t: (-alloc[t], t))
        if not victims:
            break
        alloc[victims[0]] -= 1
        overshoot -= 1
    if overshoot > 0:
        drop = sorted(alloc,
                      key=lambda t: (float(tenants[t].get("share", 0.0))
                                     if t in tenants else 0.0, t))
        for t in drop:
            if overshoot <= 0:
                break
            overshoot -= alloc.pop(t)
    return alloc


def carve(allocation: Dict[str, int],
          devices: int) -> Dict[str, Tuple[int, int]]:
    """Assign each tenant a contiguous ``(start, count)`` slice of the
    flat device order, tenants in sorted-name order.  Raises when the
    allocation does not fit — callers clamp with
    :func:`feasible_allocation` first."""
    total = sum(max(1, int(n)) for n in allocation.values())
    if total > max(1, int(devices)):
        raise ValueError(
            f"carve: allocation wants {total} devices, mesh has "
            f"{devices} — clamp with feasible_allocation first")
    slices: Dict[str, Tuple[int, int]] = {}
    start = 0
    for tenant in sorted(allocation):
        count = max(1, int(allocation[tenant]))
        slices[tenant] = (start, count)
        start += count
    return slices


def build_submesh(devices: Sequence, start: int, count: int):
    """Materialize slice ``(start, count)`` of the flat rank list as a
    1d-row mesh (``None`` for a single-device slice — that tenant
    serves through the plain local kernels, no collective in sight).
    Equal slices over equal rank lists give the same mesh, with equal
    ``mesh_fingerprint``s (invariant 2).  Creating a slice's group is a
    collective of the whole job: every rank calls this with the same
    arguments, those outside the slice too."""
    if count <= 1:
        return None
    from ..parallel.mesh import row_submesh

    devs = list(devices)[int(start):int(start) + int(count)]
    if len(devs) != count:
        raise ValueError(
            f"build_submesh: slice ({start}, {count}) falls off the "
            f"{len(list(devices))}-device mesh")
    return row_submesh(devs)


def payload_bytes(A) -> int:
    """Bytes a tenant's CSR payload occupies (data + indices +
    indptr) — the mass a migration must move."""
    return int(sum(part.numel() * part.element_size()
                   for part in (A.data, A.indices, A.indptr)))


def price_migration(payload: int, dst_devices: int) -> Dict[str, int]:
    """Price moving ``payload`` bytes onto a ``dst_devices``-wide
    submesh, via the same :func:`~legate_sparse_tpu_torch.obs.comm.
    reshard_volumes` predictor ``reshard_vector`` is ledgered by — the
    controller's prediction and the migration's recorded
    ``comm.dist_reshard.*`` bytes come from one function, so priced ==
    measured is an exact contract.

    Model: the payload lands as one chunk per destination device
    (``ceil(payload / G)`` bytes each, byte-granular elements); every
    chunk crosses the interconnect — a migration's src and dst
    placements never coincide, so the permute spans at least two
    devices even for a single-device destination slice."""
    G = max(1, int(dst_devices))
    if int(payload) <= 0:
        return {}
    chunk = -(-int(payload) // G)
    return _comm.reshard_volumes(moved_chunks=G, chunk_elems=chunk,
                                 itemsize=1, shards=max(2, G))


def priced_bytes(vols: Dict[str, int]) -> int:
    """Total predicted bytes of a priced migration (volume dict sum)."""
    return int(sum(int(v) for v in vols.values()))


def fair_share(devices: int, demanders: int) -> float:
    """Effective device share of an *unplaced* tenant: the global mesh
    divided evenly across the demanding tenants (the pre-placement
    baseline the amortization model measures savings against)."""
    return max(1, int(devices)) / max(1, int(demanders))


def effective_devices(current: Optional[Tuple[int, int]],
                      devices: int, demanders: int) -> float:
    """A tenant's effective device count today: its placed slice
    width, or the global-mesh fair share when unplaced."""
    if current is not None:
        return float(max(1, int(current[1])))
    return fair_share(devices, demanders)


def predicted_saving_ns(busy_ns: int, eff_src: float,
                        eff_dst: float) -> float:
    """Busy time a tenant is predicted to shed by moving from
    ``eff_src`` to ``eff_dst`` effective devices — the ideal-scaling
    model ``busy * (1 - src/dst)`` (docs/PLACEMENT.md).  Zero for
    shrinks: giving devices back never *saves* the moved tenant
    anything, it frees capacity for others."""
    if eff_dst <= 0 or eff_dst <= eff_src:
        return 0.0
    return float(busy_ns) * (1.0 - eff_src / eff_dst)
