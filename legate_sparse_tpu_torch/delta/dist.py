# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Mesh-scale delta serving: :class:`DistDeltaCSR`.

Counterpart of ``legate_sparse_tpu/delta/dist.py``: an immutable base
``DistCSR`` plus the bounded overwrite-wins side-buffer of
:class:`~.core.DeltaCSR`, for graphs and operators that change while a
mesh serves them.

- **Updates route to the ranks that own their rows.**  Every rank calls
  ``update`` with the same batch (SPMD, as every rank calls
  ``shard_csr``), keeps the whole host buffer (compaction and a reshard
  need it) and puts on its device only the entries of its own rows of
  the vector partition.  No byte crosses the interconnect for it.
- **The delta term is a second term on the gathered x:** ``x`` is
  all-gathered over the vector's ranks once, each rank runs
  ``ops/spmv.py::coo_spmv_segment`` over its rows, and adds the result to
  its block of the base's ``dist_spmv``.
- **Compaction is a rebuild:** the buffer merges into the ``csr_array``
  the base was sharded from (``core.merged_csr``), ``shard_csr`` rebuilds
  the base on the same mesh and layout, and the version swaps under the
  lock.
- ``reshard`` of a wrapper with pending updates carries them
  (:meth:`DistDeltaCSR._delta_reshard_carry`): additive deltas are
  relative to the base, which a reshard keeps, so the buffer moves over
  as it is.

``comm.delta.all_gather`` counts the bytes the port sends for the delta
term (x's own itemsize).  The JAX package also prices a
``comm.delta.scatter`` of each update batch to its owner shards, and of
the buffer at a reshard carry; here every rank already holds the batch,
so nothing is sent and nothing is recorded.

The vector partition is row ranges in every layout (chunk ``k`` of a
2-d layout's vector is rows ``[k L, (k+1) L)`` on rank ``k``), so the
wrapper serves the 2-d layouts too; the JAX package takes the 1d-row
layout only.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..obs import comm as _comm
from ..obs import counters as _counters
from ..obs import trace as _trace
from ..settings import settings as _settings
from .core import (_Buffer, _base_values_at, _check_batch, _nbytes,
                   _record_compaction, _record_update, _require_enabled,
                   _watermark_slots, merged_csr)

__all__ = ["DistDeltaCSR"]


class DistDeltaCSR:
    """A served distributed matrix that mutates: an immutable base
    ``DistCSR`` and a bounded COO side-buffer, its device image routed
    to the ranks that own the rows, with versioned compaction by
    re-sharding (module docstring)."""

    def __init__(self, base, capacity: Optional[int] = None):
        _require_enabled("DistDeltaCSR")
        from ..parallel.dist_csr import DistCSR

        if not isinstance(base, DistCSR):
            raise TypeError(
                f"DistDeltaCSR wraps a DistCSR (got {type(base).__name__}); "
                f"shard first via shard_csr")
        if getattr(base, "_src_csr", None) is None:
            raise ValueError(
                "DistDeltaCSR: base DistCSR carries no retained source "
                "matrix (_src_csr); build it via shard_csr")
        self._lock = threading.RLock()
        self._base = base
        self._buffer = _Buffer(
            _settings.delta_capacity if capacity is None else capacity)
        self._version = 0
        self._image = None      # (rid, cid, dvals, valid) of this rank's rows

    # ---------------- serving surface ----------------

    @property
    def shape(self):
        return self._base.shape

    @property
    def dtype(self):
        return self._base.dtype

    @property
    def base(self):
        return self._base

    @property
    def mesh(self):
        return self._base.mesh

    @property
    def layout(self) -> str:
        return self._base.layout

    @property
    def num_shards(self) -> int:
        return self._base.num_shards

    @property
    def rows_padded(self) -> int:
        return self._base.rows_padded

    @property
    def version(self) -> int:
        return self._version

    @property
    def pending(self) -> int:
        return self._buffer.pending

    @property
    def capacity(self) -> int:
        return self._buffer.capacity

    def dot(self, x):
        """``y = base (x) + delta (x)``: the base term through
        ``dist_spmv``, the delta term on the all-gathered x over this
        rank's rows.  ``x`` and the result follow ``dist_spmv``'s
        contract (a sharded vector of length ``rows_padded``, or this
        rank's block); an empty buffer is the base dispatch alone, bit
        for bit."""
        from torch.distributed.tensor import DTensor

        from ..ops.spmv import coo_spmv_segment
        from ..parallel import dist_csr as _dc

        with self._lock:
            base, image = self._base, self._image
            version, pending = self._version, self._buffer.pending
        if image is None:
            return _dc.dist_spmv(base, x)
        x_local = _dc._local(x)
        y = _dc.dist_spmv(base, x_local)
        _counters.handle("delta.served").inc()
        group = base.vector_group
        _comm.record("delta", {"all_gather": _comm.all_gather_bytes(
            x_local.shape[0], x_local.element_size(),
            dist.get_world_size(group))},
            calls={"all_gather": 1}, layout=base.layout)
        rid, cid, dvals, valid = image
        cdt = torch.promote_types(base.dtype, x_local.dtype)
        with _trace.span("delta.serve", version=version, pending=pending,
                         path="coo-segment", dist=True):
            x_full = _dc._all_gather(x_local, group)
            yd = coo_spmv_segment(dvals.to(cdt), rid, cid, valid,
                                  x_full.to(cdt), base.local_len)
        y = y + yd
        if not isinstance(x, DTensor):
            return y
        return _dc._global_vector(base, y, base.rows_padded)

    # ---------------- mutation ----------------

    def update(self, rows, cols, vals):
        """Absolute entry updates, as :meth:`DeltaCSR.update`
        (overwrite wins, 0.0 deletes at compaction, the typed capacity
        error); each rank keeps the entries of its own rows on its
        device."""
        t0 = time.perf_counter_ns()
        rows, cols, vals = _check_batch(self.shape, rows, cols, vals)
        with self._lock:
            base = self._base
            base_vals = _base_values_at(base._src_csr, rows, cols)
            new_slots, overwrites = self._buffer.ingest(rows, cols, vals,
                                                        base_vals)
            self._refresh_image()
            pending = self._buffer.pending
        owners = rows // np.int64(base.local_len)
        _record_update(t0, new_slots, overwrites, pending, self._version,
                       dist=True, shards_touched=int(np.unique(owners).size))
        if pending >= _watermark_slots(self._buffer.capacity):
            _counters.inc("delta.watermark.exceeded")
            _trace.event("delta.watermark", pending=pending,
                         capacity=self._buffer.capacity)

    set_entries = update

    def entries(self) -> Dict[Tuple[int, int], float]:
        """Pending buffered targets ``{(row, col): value}``."""
        with self._lock:
            return {k: tv for k, (tv, _d) in self._buffer.entries.items()}

    # ---------------- compaction / versioned swap ----------------

    def compact(self) -> int:
        """Merge the buffer into the base's source matrix, re-shard it on
        the same mesh and layout and swap versions.  Returns the number
        of entries merged."""
        from ..parallel.dist_csr import shard_csr

        t0 = time.perf_counter_ns()
        with self._lock:
            base = self._base
            merged = self._buffer.pending
            if merged == 0:
                return 0
            new_src = merged_csr(base._src_csr, self._buffer.entries)
            with _trace.span("delta.compaction", dist=True, merged=merged):
                new_base = shard_csr(new_src, mesh=base.mesh,
                                     layout=base.layout)
            self._buffer.entries.clear()
            self._base = new_base
            self._image = None
            self._version += 1
            version = self._version
        _record_compaction(t0, merged, version, new_src.nnz,
                           _nbytes(new_src), dist=True)
        return merged

    def maybe_compact(self) -> int:
        """Compact if the buffer is at the watermark."""
        if self._buffer.pending >= _watermark_slots(self._buffer.capacity):
            return self.compact()
        return 0

    def _refresh_image(self) -> None:
        """Rebuild this rank's device image (callers hold the lock): the
        entries of its rows of the vector partition, rows local, the
        sentinel its block length."""
        if self._buffer.pending == 0:
            self._image = None
            return
        from ..parallel import dist_csr as _dc

        base = self._base
        L = base.local_len
        start = _dc._chunk_index(base.mesh, base.layout) * L
        self._image = self._buffer.device_image(
            base.dtype, base.device, sentinel_row=L, start=start,
            stop=start + L)

    # ---------------- reshard carry ----------------

    def _delta_reshard_carry(self, mesh, layout):
        """``reshard``'s hook: repartition the base and carry the pending
        buffer, never dropping an update.  Additive deltas are relative
        to the base, which the repartition keeps, so the buffer moves
        over as it is; each rank re-routes its own rows."""
        from ..parallel.reshard import reshard as _reshard

        with self._lock:
            new_base = _reshard(self._base, mesh=mesh, layout=layout)
            if new_base is self._base:
                return self
            out = DistDeltaCSR(new_base, capacity=self._buffer.capacity)
            out._buffer.entries.update(self._buffer.entries)
            out._version = self._version
            out._refresh_image()
        if out._buffer.pending:
            _trace.event("delta.reshard_carry", pending=out._buffer.pending,
                         version=out._version)
        return out

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"DistDeltaCSR(v{self._version}, "
                f"pending={self.pending}/{self.capacity}, "
                f"shape={self.shape}, shards={self._base.num_shards})")
