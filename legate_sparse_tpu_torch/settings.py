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

The serving layers, all off by default (each off switch is one
attribute read at its dispatch site, and nothing else):

``engine`` (``LEGATE_SPARSE_TPU_ENGINE``, off)
    Route eligible ``csr_array.dot`` and solver products through the
    shape-bucketed plans of ``legate_sparse_tpu_torch.engine``.
``engine_bucket_ladder`` (``LEGATE_SPARSE_TPU_ENGINE_BUCKETS``, empty)
    Comma-separated bucket rungs; empty is the power-of-two policy.
``engine_min_bucket`` (``LEGATE_SPARSE_TPU_ENGINE_MIN_BUCKET``, 64)
    Smallest bucket.
``engine_plan_cache_size`` (``LEGATE_SPARSE_TPU_ENGINE_PLANS``, 128)
    Plans the LRU holds.
``engine_max_batch`` (``LEGATE_SPARSE_TPU_ENGINE_BATCH``, 8),
``engine_queue_depth`` (``LEGATE_SPARSE_TPU_ENGINE_QUEUE``, 64),
``engine_batch_timeout_ms`` (``LEGATE_SPARSE_TPU_ENGINE_BATCH_TIMEOUT_MS``, 2.0)
    The request executor's batch width, pending-request bound and age
    at which its worker dispatches a batch (0: no worker).
``resil`` (``LEGATE_SPARSE_TPU_RESIL``, off) and ``resil_retries`` (2),
``resil_backoff_ms`` (1.0), ``resil_backoff_mult`` (2.0),
``resil_backoff_max_ms`` (50.0), ``resil_retry_budget`` (64),
``resil_breaker_k`` (3), ``resil_breaker_cooldown_ms`` (100.0)
    Fault injection, retries, breakers and deadlines
    (``legate_sparse_tpu_torch.resilience``), each under
    ``LEGATE_SPARSE_TPU_<NAME>``.
``resil_health`` (off), ``resil_stagnation_cycles`` (0: off),
``resil_divergence_mult`` (1e8), ``resil_ckpt_iters`` (0: no
snapshots), ``resil_abft`` (off), each under
``LEGATE_SPARSE_TPU_<NAME>``
    Solver health verdicts at the convergence fetches, the
    distributed solvers' default checkpoint cadence, and the
    ABFT-checked distributed SpMV; all need ``resil`` on.
``gateway`` (``LEGATE_SPARSE_TPU_GATEWAY``, off) and
``gateway_max_batch`` (``_BATCH``, 8), ``gateway_queue_depth``
(``_QUEUE``, 128), ``gateway_tenant_quota`` (``_TENANT_QUOTA``, 32),
``gateway_rate`` (``_RATE``, 0.0), ``gateway_burst`` (``_BURST``, 16.0),
``gateway_slack_ms`` (``_SLACK_MS``, 5.0), ``gateway_timeout_ms``
(``_TIMEOUT_MS``, 2.0), each under ``LEGATE_SPARSE_TPU_GATEWAY``
    The multi-tenant admission gateway (``engine.gateway``).
``autotune`` (``LEGATE_SPARSE_TPU_AUTOTUNE``, off) and
``autotune_store_path`` (``_STORE``, empty), ``autotune_store_size``
(``_VERDICTS``, 256), ``autotune_trials`` (``_TRIALS``, 5),
``autotune_warmup`` (``_WARMUP``, 1), each under
``LEGATE_SPARSE_TPU_AUTOTUNE``
    Measured kernel verdicts (``legate_sparse_tpu_torch.autotune``).

The JAX package's ``engine_persist_dir`` has no counterpart: it backs
XLA's persistent compilation cache, and an eager plan compiles nothing.

``epoch`` counts the value changes, after import, of every setting that
can change what a product computes (all but ``_EPOCH_EXEMPT``); plan and
verdict keys carry it, so such a change retires their entries.
"""

from __future__ import annotations

import os


def _parse_ladder(spec: str) -> tuple:
    """A bucket ladder ("1024,4096,65536") as an ascending int tuple;
    empty is () (the power-of-two policy).  A malformed ladder raises."""
    spec = spec.strip()
    if not spec:
        return ()
    try:
        rungs = tuple(sorted({int(tok) for tok in spec.split(",")
                              if tok.strip()}))
    except ValueError:
        raise ValueError(
            f"LEGATE_SPARSE_TPU_ENGINE_BUCKETS={spec!r}: expected "
            f"comma-separated integers") from None
    if rungs and rungs[0] <= 0:
        raise ValueError(
            f"LEGATE_SPARSE_TPU_ENGINE_BUCKETS={spec!r}: rungs must be "
            f"positive")
    return rungs


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
        env = os.environ.get
        self.engine: bool = _env_bool("LEGATE_SPARSE_TPU_ENGINE", False)
        self.engine_bucket_ladder: tuple = _parse_ladder(
            env("LEGATE_SPARSE_TPU_ENGINE_BUCKETS", ""))
        self.engine_min_bucket: int = int(
            env("LEGATE_SPARSE_TPU_ENGINE_MIN_BUCKET", "64"))
        self.engine_plan_cache_size: int = int(
            env("LEGATE_SPARSE_TPU_ENGINE_PLANS", "128"))
        self.engine_max_batch: int = int(
            env("LEGATE_SPARSE_TPU_ENGINE_BATCH", "8"))
        self.engine_queue_depth: int = int(
            env("LEGATE_SPARSE_TPU_ENGINE_QUEUE", "64"))
        self.engine_batch_timeout_ms: float = float(
            env("LEGATE_SPARSE_TPU_ENGINE_BATCH_TIMEOUT_MS", "2.0"))
        self.resil: bool = _env_bool("LEGATE_SPARSE_TPU_RESIL", False)
        self.resil_retries: int = int(
            env("LEGATE_SPARSE_TPU_RESIL_RETRIES", "2"))
        self.resil_backoff_ms: float = float(
            env("LEGATE_SPARSE_TPU_RESIL_BACKOFF_MS", "1.0"))
        self.resil_backoff_mult: float = float(
            env("LEGATE_SPARSE_TPU_RESIL_BACKOFF_MULT", "2.0"))
        self.resil_backoff_max_ms: float = float(
            env("LEGATE_SPARSE_TPU_RESIL_BACKOFF_MAX_MS", "50.0"))
        self.resil_retry_budget: int = int(
            env("LEGATE_SPARSE_TPU_RESIL_RETRY_BUDGET", "64"))
        self.resil_breaker_k: int = int(
            env("LEGATE_SPARSE_TPU_RESIL_BREAKER_K", "3"))
        self.resil_breaker_cooldown_ms: float = float(
            env("LEGATE_SPARSE_TPU_RESIL_BREAKER_COOLDOWN_MS", "100.0"))
        self.resil_health: bool = _env_bool(
            "LEGATE_SPARSE_TPU_RESIL_HEALTH", False)
        self.resil_stagnation_cycles: int = int(
            env("LEGATE_SPARSE_TPU_RESIL_STAGNATION_CYCLES", "0"))
        self.resil_divergence_mult: float = float(
            env("LEGATE_SPARSE_TPU_RESIL_DIVERGENCE_MULT", "1e8"))
        self.resil_ckpt_iters: int = int(
            env("LEGATE_SPARSE_TPU_RESIL_CKPT_ITERS", "0"))
        self.resil_abft: bool = _env_bool(
            "LEGATE_SPARSE_TPU_RESIL_ABFT", False)
        self.gateway: bool = _env_bool("LEGATE_SPARSE_TPU_GATEWAY", False)
        self.gateway_max_batch: int = int(
            env("LEGATE_SPARSE_TPU_GATEWAY_BATCH", "8"))
        self.gateway_queue_depth: int = int(
            env("LEGATE_SPARSE_TPU_GATEWAY_QUEUE", "128"))
        self.gateway_tenant_quota: int = int(
            env("LEGATE_SPARSE_TPU_GATEWAY_TENANT_QUOTA", "32"))
        self.gateway_rate: float = float(
            env("LEGATE_SPARSE_TPU_GATEWAY_RATE", "0.0"))
        self.gateway_burst: float = float(
            env("LEGATE_SPARSE_TPU_GATEWAY_BURST", "16.0"))
        self.gateway_slack_ms: float = float(
            env("LEGATE_SPARSE_TPU_GATEWAY_SLACK_MS", "5.0"))
        self.gateway_timeout_ms: float = float(
            env("LEGATE_SPARSE_TPU_GATEWAY_TIMEOUT_MS", "2.0"))
        self.autotune: bool = _env_bool("LEGATE_SPARSE_TPU_AUTOTUNE", False)
        self.autotune_store_path: str = env(
            "LEGATE_SPARSE_TPU_AUTOTUNE_STORE", "")
        self.autotune_store_size: int = int(
            env("LEGATE_SPARSE_TPU_AUTOTUNE_VERDICTS", "256"))
        self.autotune_trials: int = int(
            env("LEGATE_SPARSE_TPU_AUTOTUNE_TRIALS", "5"))
        self.autotune_warmup: int = int(
            env("LEGATE_SPARSE_TPU_AUTOTUNE_WARMUP", "1"))
        self._epoch: int = 0
        self._init_done: bool = True

    # Settings that cannot change what a product computes: the routing
    # switches and the queueing, capacity, resilience, graph-loop and
    # delta-buffer policies (the JAX package's set, less its TPU-only
    # names).  Bucket-policy knobs are not exempt: they change plan keys.
    _EPOCH_EXEMPT = frozenset({
        "obs", "engine", "engine_max_batch", "engine_queue_depth",
        "engine_batch_timeout_ms", "engine_plan_cache_size",
        "_epoch", "_init_done",
        "resil", "resil_retries", "resil_backoff_ms",
        "resil_backoff_mult", "resil_backoff_max_ms",
        "resil_retry_budget", "resil_breaker_k",
        "resil_breaker_cooldown_ms", "resil_health",
        "resil_stagnation_cycles", "resil_divergence_mult",
        "resil_ckpt_iters", "resil_abft",
        "gateway", "gateway_max_batch", "gateway_queue_depth",
        "gateway_tenant_quota", "gateway_rate", "gateway_burst",
        "gateway_slack_ms", "gateway_timeout_ms",
        "graph_max_iters", "graph_conv_iters",
        "delta", "delta_capacity", "delta_watermark", "delta_worker_ms",
        "autotune", "autotune_store_path", "autotune_store_size",
        "autotune_trials", "autotune_warmup",
    })

    def __setattr__(self, name: str, value) -> None:
        # A value change after init of a setting outside the exempt set
        # bumps the epoch; rewriting the same value does not.
        d = self.__dict__
        if (d.get("_init_done") and name not in self._EPOCH_EXEMPT
                and (name not in d or d[name] != value)):
            d["_epoch"] = d.get("_epoch", 0) + 1
        super().__setattr__(name, value)

    @property
    def epoch(self) -> int:
        """Count of value changes of non-exempt settings since import
        (a plan- and verdict-key term)."""
        return self._epoch

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
