# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Environment-driven settings.

Mirrors the SpMV-dispatch knobs of ``legate_sparse_tpu/settings.py``
(``Settings.__init__``), under the same environment names and
defaults, so one environment configures both packages alike.  Each is
read once at import and can be overridden by assignment.

``dia_max_expand`` (``LEGATE_SPARSE_TPU_DIA_EXPAND``, 2.0)
    A CSR matrix is taken as banded when its distinct diagonals number
    at most ``dia_max_expand * nnz / cols`` (and ``dia_max_diags``).
    0 disables band detection.
``dia_max_diags`` (``LEGATE_SPARSE_TPU_DIA_MAX_DIAGS``, 128)
    Most diagonals a band may have; also the DIA kernel's limit.
``ell_max_expand`` (``LEGATE_SPARSE_TPU_ELL_EXPAND``, 4.0)
    ELL packing when ``rows * max_row_nnz <= ell_max_expand * nnz``.
``bsr_max_expand`` (``LEGATE_SPARSE_TPU_BSR_EXPAND``, 128.0)
    BSR structure when the densified present blocks hold at most this
    multiple of nnz.  0 disables BSR.
``bsr_force`` (``LEGATE_SPARSE_TPU_BSR_FORCE``, off)
    Build the BSR structure on any device (on the CPU its wrapper runs
    the plain version) — the differential-testing hook.
``spgemm_chunk_products`` (``LEGATE_SPARSE_SPGEMM_CHUNK``, 2^24)
    Most products per ESC expansion chunk: a product that expands more
    runs in chunks, so peak memory is O(chunk + nnz(C)) instead of
    O(T).  The JAX package's ``LEGATE_SPARSE_FAST_SPGEMM`` (one pass,
    whatever T) has no counterpart: a chunk of at least T is one pass.
``precise_images`` (``LEGATE_SPARSE_PRECISE_IMAGES``, off)
    ``parallel.shard_csr`` realizes x by each shard's exact gather plan
    (the unique columns it reads, exchanged by one ``all_to_all``)
    instead of the min/max column window.
``dist_layout`` (``LEGATE_SPARSE_TPU_DIST_LAYOUT``, ``"1d-row"``)
    The partition layout ``parallel.shard_csr`` takes when the caller
    names none (``parallel.mesh.resolve_layout``).
``obs`` (``LEGATE_SPARSE_TPU_OBS``, off)
    Span tracing (``legate_sparse_tpu_torch.obs``): a property that
    reads and sets ``obs.trace``'s switch, so ``settings.obs = True``
    and the environment variable are the same switch, as in the JAX
    package.  Counters and latency histograms are on either way.
``graph_max_iters`` (``LEGATE_SPARSE_TPU_GRAPH_MAX_ITERS``, 0)
    Sweep cap of the graph traversals (BFS, connected components); 0
    derives it from the vertex count (n + 1).  SSSP keeps its n-sweep
    cap, its negative-cycle detector.
``graph_conv_iters`` (``LEGATE_SPARSE_TPU_GRAPH_CONV_ITERS``, 5)
    PageRank iterations per host fetch of its convergence test.
``delta`` (``LEGATE_SPARSE_TPU_DELTA``, off)
    The delta layer (``legate_sparse_tpu_torch.delta``): its
    constructors raise while it is off.
``delta_capacity`` (``LEGATE_SPARSE_TPU_DELTA_CAPACITY``, 1024)
    Distinct (row, col) update slots a delta buffer holds before
    ``update`` raises ``DeltaCapacityError``.
``delta_watermark`` (``LEGATE_SPARSE_TPU_DELTA_WATERMARK``, 0.75)
    Fraction of the capacity at which ``maybe_compact`` merges and an
    update arms the compaction worker.
``delta_worker_ms`` (``LEGATE_SPARSE_TPU_DELTA_WORKER_MS``, 0)
    The compaction worker's cadence in ms; 0 starts no worker.
"""

from __future__ import annotations

import os


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.lower() not in ("0", "false", "no", "off", "")


class Settings:
    def __init__(self) -> None:
        self.ell_max_expand: float = float(
            os.environ.get("LEGATE_SPARSE_TPU_ELL_EXPAND", "4.0"))
        self.dia_max_expand: float = float(
            os.environ.get("LEGATE_SPARSE_TPU_DIA_EXPAND", "2.0"))
        self.dia_max_diags: int = int(
            os.environ.get("LEGATE_SPARSE_TPU_DIA_MAX_DIAGS", "128"))
        self.bsr_max_expand: float = float(
            os.environ.get("LEGATE_SPARSE_TPU_BSR_EXPAND", "128.0"))
        self.bsr_force: bool = _env_bool("LEGATE_SPARSE_TPU_BSR_FORCE",
                                         False)
        self.spgemm_chunk_products: int = int(
            os.environ.get("LEGATE_SPARSE_SPGEMM_CHUNK", 1 << 24))
        self.precise_images: bool = _env_bool(
            "LEGATE_SPARSE_PRECISE_IMAGES", False)
        self.dist_layout: str = os.environ.get(
            "LEGATE_SPARSE_TPU_DIST_LAYOUT", "1d-row")
        self.graph_max_iters: int = int(
            os.environ.get("LEGATE_SPARSE_TPU_GRAPH_MAX_ITERS", "0"))
        self.graph_conv_iters: int = int(
            os.environ.get("LEGATE_SPARSE_TPU_GRAPH_CONV_ITERS", "5"))
        self.delta: bool = _env_bool("LEGATE_SPARSE_TPU_DELTA", False)
        self.delta_capacity: int = int(
            os.environ.get("LEGATE_SPARSE_TPU_DELTA_CAPACITY", "1024"))
        self.delta_watermark: float = float(
            os.environ.get("LEGATE_SPARSE_TPU_DELTA_WATERMARK", "0.75"))
        self.delta_worker_ms: float = float(
            os.environ.get("LEGATE_SPARSE_TPU_DELTA_WORKER_MS", "0"))

    @property
    def obs(self) -> bool:
        from .obs import trace

        return trace.enabled()

    @obs.setter
    def obs(self, value: bool) -> None:
        from .obs import trace

        if value:
            trace.enable()
        else:
            trace.disable()


settings = Settings()
