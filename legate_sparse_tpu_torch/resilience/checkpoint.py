# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Solver checkpoint/restore: restartable snapshots at the fetch
cadence (the port of ``legate_sparse_tpu/resilience/checkpoint.py``).

A Krylov solve is a long straight-line computation whose only durable
output is its final iterate — lose a device mid-run and every
completed iteration is gone.  This module makes solves restartable
without adding a host sync: the solvers already fetch convergence
state once per stretch (CG) or restart cycle (GMRES), and a checkpoint
scope rides exactly that cadence::

    with checkpoint.scope("dist.cg", every=50):
        x, iters = dist_cg(A, b)        # snapshot every >= 50 iters

Every ``every`` iterations the solver hands the scope its restartable
state — ``(x, r, p)`` for CG, the Arnoldi seed ``x`` for GMRES — and
the scope copies it into HOST numpy arrays (a dtype numpy lacks, bf16,
stays a CPU tensor).  Host copies are the point: a snapshot on the card
dies with the card, while a host copy survives any device loss.  A
card's tensors go into page-locked buffers the scope allocates at its
first save and reuses at each later one (a copy into fresh pageable
memory runs several times slower), so the snapshot held is overwritten
by the next save: take a copy to keep an older one.  In a distributed solve the solver all-gathers each block
into the whole padded vector first, so every rank's snapshot holds the
full iterate and any survivor can restart from it.  The copy
synchronises anyway (the device-to-host transfer); ``resil.ckpt.ms``
times it and nothing else, and no other sync is added.

After a :class:`~.outcomes.DeviceLost`, the recovery ladder in
``dist_cg`` / ``dist_gmres`` calls :meth:`SolverCheckpoint.restore`,
re-shards the snapshot over the survivor mesh, and resumes — CG
restarted from a checkpointed ``x`` re-derives ``r`` and ``p`` from
scratch (a plain restart), which preserves convergence to tolerance;
it does not replay the exact iterate sequence.

Like ``deadline``, scopes are ``contextvars``-propagated and inert
without ``LEGATE_SPARSE_TPU_RESIL``: the instrumented solvers read the
flag before consulting the scope, and ``scope()`` with the default
cadence of 0 (``settings.resil_ckpt_iters``) never snapshots.

Counters::

    resil.ckpt.saves      snapshots taken
    resil.ckpt.bytes      host bytes copied across all saves
    resil.ckpt.ms         accumulated device->host copy milliseconds
    resil.ckpt.restores   snapshots handed back to a recovery ladder
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, Iterator, Optional, Sequence, Tuple

from .. import obs as _obs
from ..settings import settings as _settings


def _to_host(a: Any, buf: Any = None) -> Tuple[Any, Any]:
    """``(host copy of a, buffer)``: a card tensor copied into the
    page-locked CPU tensor ``buf`` (allocated when None or of another
    shape or dtype), a CPU tensor or array-like copied afresh; numpy
    where it has the dtype, else the CPU tensor."""
    import numpy as np
    import torch

    if not isinstance(a, torch.Tensor):
        return np.array(a), None
    a = a.detach()
    if a.device.type == "cpu":
        t = a.clone()
    else:
        if (buf is None or buf.shape != a.shape
                or buf.dtype != a.dtype):
            buf = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        t = buf
        t.copy_(a)
    try:
        return t.numpy(), buf
    except TypeError:
        return t, buf


def _nbytes(a: Any) -> int:
    if hasattr(a, "nbytes"):
        return int(a.nbytes)
    return int(a.numel() * a.element_size())


class SolverCheckpoint:
    """Host-buffered snapshots of one solve's restartable state.

    ``every`` is the snapshot cadence in *iterations* (not cycles):
    the solver calls :meth:`maybe_save` at each convergence fetch and
    a snapshot is taken whenever at least ``every`` iterations have
    elapsed since the last one (the first eligible fetch always
    saves).  ``every <= 0`` disables snapshotting; the scope then only
    routes ``cg`` through its resilient stretches."""

    def __init__(self, site: str, every: int):
        self.site = site
        self.every = int(every)
        self.iterations = -1          # iteration count of last save
        self.arrays: Optional[Tuple[Any, ...]] = None
        self.saves = 0
        self.restores = 0
        self.nbytes = 0               # bytes of the LAST snapshot
        self._buffers: Tuple[Any, ...] = ()   # page-locked, reused

    def due(self, iterations: int) -> bool:
        """Would :meth:`maybe_save` at ``iterations`` take a snapshot?"""
        if self.every <= 0:
            return False
        return (self.arrays is None
                or int(iterations) - self.iterations >= self.every)

    def maybe_save(self, iterations: int, arrays: Sequence[Any]) -> bool:
        """Snapshot ``arrays`` if the cadence says so; True if saved."""
        if not self.due(iterations):
            return False
        self.save(iterations, arrays)
        return True

    def save(self, iterations: int, arrays: Sequence[Any]) -> None:
        """Unconditionally snapshot ``arrays`` into host buffers."""
        t0 = time.monotonic_ns()
        bufs = self._buffers + (None,) * (len(arrays) - len(self._buffers))
        pairs = [_to_host(a, buf) for a, buf in zip(arrays, bufs)]
        ms = (time.monotonic_ns() - t0) / 1e6
        snap = tuple(p[0] for p in pairs)
        self._buffers = tuple(p[1] for p in pairs)
        self.arrays = snap
        self.iterations = int(iterations)
        self.saves += 1
        self.nbytes = sum(_nbytes(a) for a in snap)
        _obs.inc("resil.ckpt.saves")
        _obs.inc("resil.ckpt.bytes", self.nbytes)
        _obs.inc("resil.ckpt.ms", ms)
        _obs.event("resil.ckpt", site=self.site,
                   iterations=self.iterations, nbytes=self.nbytes)

    def restore(self) -> Optional[Tuple[int, Tuple[Any, ...]]]:
        """Hand back ``(iterations, arrays)`` of the last snapshot, or
        None when nothing was ever saved (the ladder then restarts the
        solve from its original ``x0`` at iteration 0)."""
        if self.arrays is None:
            return None
        self.restores += 1
        _obs.inc("resil.ckpt.restores")
        _obs.event("resil.ckpt.restore", site=self.site,
                   iterations=self.iterations)
        return self.iterations, self.arrays

    def rebase(self, iterations: int = 0) -> None:
        """Re-key the held snapshot to a new iteration origin.  The
        recovery ladder calls this after consuming a restore: the
        resumed solve counts its iterations from 0 again, so the same
        snapshot now represents iteration 0 of the resumed lineage
        (its credit has already been banked by the ladder)."""
        self.iterations = int(iterations)


_var: contextvars.ContextVar[Optional[SolverCheckpoint]] = (
    contextvars.ContextVar("legate_sparse_tpu_torch_resil_ckpt",
                           default=None))


@contextlib.contextmanager
def scope(site: str = "solver",
          every: Optional[int] = None) -> Iterator[SolverCheckpoint]:
    """Bind a checkpoint scope for the enclosed solve.  ``every``
    defaults to ``settings.resil_ckpt_iters`` (0 = no snapshots).
    Unlike deadlines, scopes do not compose: the innermost scope owns
    the solve it encloses (an outer scope's snapshots would mix two
    solves' state)."""
    ck = SolverCheckpoint(
        site, _settings.resil_ckpt_iters if every is None else every)
    token = _var.set(ck)
    try:
        yield ck
    finally:
        _var.reset(token)


def current() -> Optional[SolverCheckpoint]:
    """The innermost active checkpoint scope, or None."""
    return _var.get()


def active() -> bool:
    """True iff a checkpoint scope is bound (callers gate on
    ``settings.resil`` before consulting this, as with deadlines)."""
    return _var.get() is not None
