# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""legate_sparse_tpu_torch.placement: closed-loop elastic placement (the
port of ``legate_sparse_tpu/placement``).

Connects the three layers prior PRs built — the per-tenant cost
sensors (``obs.attrib`` / ``obs.capacity``), the SLO burn alarm
(``obs.slo``) and the exactly-priced reshard actuator
(``parallel/reshard.py``) — into one control loop (docs/PLACEMENT.md):

- ``submesh``    — pure carving of the flat device order (the job's
                   ranks) into contiguous per-tenant submeshes,
                   fingerprint-stable so dist plans survive epochs.
- ``controller`` — the pure ``propose()`` (sizing + carve + priced
                   amortization) and the epoch-driven
                   ``PlacementController`` (cooldown, thrash
                   detection, optional watchdog).
- ``migrate``    — the placed-tenant registry and live migration:
                   versioned placements atomically swapped behind the
                   gateway, in-flight requests draining on their
                   pinned version.

Inert by default: without ``LEGATE_SPARSE_TPU_PLACEMENT`` the gateway
pays one flag read per armed admission, ``step()`` returns ``None``
after the same single read, no ``placement.*`` counter moves, and
served values are bit-for-bit those of the unplaced path (pinned by
tests/test_torch_placement.py).
"""

from . import controller, migrate, submesh  # noqa: F401
from .controller import (  # noqa: F401
    PlacementController, PlacementDecision, PlacementSnapshot, propose,
)
from .migrate import (  # noqa: F401
    PlacedHandle, flag_shrink, is_placed_handle, migrate_to, place,
    registry, route,
)

__all__ = [
    "controller", "migrate", "submesh",
    "PlacementController", "PlacementDecision", "PlacementSnapshot",
    "propose",
    "PlacedHandle", "flag_shrink", "is_placed_handle", "migrate_to",
    "place", "registry", "route", "reset",
]


def reset() -> None:
    """Test isolation: drop every placed tenant and shrink flag (the
    controller instances are caller-owned; stop their watchdogs
    yourself)."""
    migrate.reset()
