#!/usr/bin/env python3
# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Bench of the PyTorch port: banded SpMV bandwidth on one card, and
``bench.py``'s other phases under its field names.

The port of ``bench.py``, at its configurations and sizes, under its
JSON field names (``schema_version`` 20).  Run it from the root of a
checkout::

    python bench_torch.py                      # on cuda; raises without one
    python bench_torch.py --smoke --device cpu # every phase, tiny, ~1 min

It prints ONE JSON line, last on stdout::

    {"metric": "csr_spmv_bandwidth", "value": <GB/s>, "unit": "GB/s",
     "vs_baseline": <value / median stream GB/s>, "platform": "cuda", ...}

Phases, in order (any that raises ends the run with a non-zero exit):

- stream: ``bench_timing.triad_gbs`` (``x' = a*x + y``, 2^26 f32 lanes),
  2 samples before the SpMV phase and 3 after; ``stream_gbs`` is their
  median, ``stream_samples``/``_min``/``_max`` their spread;
- SpMV: ``_banded_config(2^24, 11)`` (f32, row sums 1) times a vector of
  ones: ``spmv_ms`` (``bench_timing.time_ms``: CUDA events around 10
  calls, median of 25), ``value`` (its bytes over its time), ``path``
  (``dia``/``ell``/``csr``), the byte model per nonzero of the f32 and
  the compressed (bf16) storage;
- ``obs_overhead_pct``: the chained SpMV with an obs span a step, tracing
  on against off (``loop_ms_per_iter``), clamped at 0;
- CG on the 1024^2 5-point Poisson grid: ``cg_ms_per_iter``, the median
  of 5 differences (300 - 100 iterations, rtol 0, synchronised) over
  200, with their min and max;
- irregular: ``_irregular_config(2^20, 11)`` (one heavy row, random
  columns), the chained normalised SpMV (``loop_ms_per_iter``):
  ``irregular_gbs``, ``irregular_frac``;
- BSR: 2^13 rows at density 0.05 (scipy, seed 1) through the BSR kernel
  (``ops/bsr.py::build_structure``): ``bsr_ms`` (``time_ms``),
  ``bsr_gbs`` (8 bytes a nonzero), ``bsr_stream_gbs`` (the present
  blocks as dense 128x128 f32 tiles);
- SpGEMM: ``A @ A`` of ``_banded_config(2^20, 11)``, the median of 5
  synchronised products (``spgemm_ms``) beside host scipy's
  (``spgemm_scipy_ms``) on the same matrix;
- GMG: ``parallel.DistGMG`` (3 levels) on the 512^2 Poisson grid, on
  one rank started by ``parallel.launch.run_ranks`` (NCCL on ``cuda``,
  gloo on the CPU): ``gmg_cycle_ms`` (chained normalised V-cycles,
  ``loop_ms_per_iter``) and ``gmg_cg_ms_per_iter`` (``dist_cg``, the
  median of 5 differences of 60 and 20 iterations over 40);
- ``cg_1m``: CG on the 1000^2 grid, the median of 5 differences (150 -
  50) over 100;
- ``pde_4096``: the explicit update ``v - 0.25*(A@v) + b`` on the 4096^2
  grid (``loop_ms_per_iter``), its bytes (the SpMV's and b's), its bf16
  twin (``compress()`` storage and bf16 state) and, against the stream
  median, ``pde_stream_bound_ms`` and ``pde_roofline_ratio``;
- bf16: ``_banded_config(2^24, 11)`` in bf16 times bf16 ones
  (``time_ms``): ``bf16_ms``, ``bf16_gbs``;
- the distributed phases, in ONE ``run_ranks`` launch (every rank makes
  the same calls; rank 0 returns the fields): one NCCL rank per visible
  card on ``cuda``; under ``--smoke`` exactly 8 gloo ranks on the CPU,
  one thread each, as ``bench.py``'s smoke forces 8 devices:

  - dist: ``_banded_config(2^22, 11)`` row-sharded: ``dist_shards``,
    ``dist_spmv_comm_bytes`` (``spmv_comm_volumes``), ``dist_spmv_ms``
    (``loop_ms_per_iter``), a 25-iteration ``dist_cg`` (rtol 0):
    ``dist_cg_iters``, ``dist_cg_comm_bytes``; ``comm_total_bytes``;
  - dist2d: ``_dist2d_config(2^20, 11)`` on the 1-d row mesh (the
    baselines ``dist2d_spmv_1d_comm_bytes``,
    ``dist2d_spgemm_1d_comm_bytes``) and on ``make_grid_mesh`` with
    ``layout="auto"`` (``dist2d_layout``, ``dist2d_grid``, the SpMV's
    bytes and ms, its ``compress()`` twin's bytes with a bf16 x, a
    25-iteration ``dist_cg``, ``dist_spgemm``'s wire bytes);
  - recovery (2 ranks or more): ``dist_cg`` on ``_banded_config(2^16)``
    with a checkpoint every 10 iterations and a ``device_loss`` of rank
    1 at the second fetch: ``resil_ckpt_saves``, ``resil_recoveries``,
    ``resil_restored``, ``resil_reshard_bytes``, the clean and recovered
    ms;
  - graph: BFS, SSSP, CC and PageRank (tol 0, 20 sweeps) on
    ``gallery.rmat(13, 4)`` (seed 1234): ``graph_<alg>_iters``,
    ``graph_<alg>_comm_bytes``, ``graph_ms``;
  - attrib's wire: two ``dist_spmv`` of ``_banded_config(2^14)`` under
    attribution, one for a tenant, one for three: ``attrib_comm_bytes``,
    ``attrib_tenant_comm_bytes``, ``attrib_tenants``,
    ``attrib_conserved``;
  - placement: two placed tenants served through the gateway, carved by
    ``propose`` over a fixed snapshot and migrated, then served again:
    ``placement_migrations``, ``_reshard_bytes``, ``_routes``,
    ``_noisy_served``, ``_quiet_served``, ``placement_ms``;

- the serving phases, in this process: engine (cold, warm and batched
  ms, plan hits and misses), resil (a fail-twice retry, a K = 3 breaker
  trip, a deadline shed), saturation (closed-loop clients on a
  ``RequestExecutor``: p50/p99 a level, totals), gateway (the WFQ
  packing stage and the flood stage: admission totals a tenant), attrib
  (a two-tenant gateway load under attribution: ``attrib_requests``,
  ``attrib_packed``), mutation (a ``DeltaCSR`` served through the
  gateway under a seeded update stream, one compaction), autotune (a
  power-law matrix's verdict, pinned under ``--smoke``, one routed
  dispatch, the sliced ELL against csr-rowids);
- ``mem_peak_rss_mb``, ``mem_device_peak_mb`` (null on the CPU) and
  ``bench_wall_s``.

Ratios against the stream median (``vs_baseline``, ``irregular_frac``)
name the card's achievable bandwidth as measured in the same run; on the
CPU ``vs_baseline`` is null and the ratio is ``cpu_vs_baseline``.  The
record also names the card and its power limit (``device_name``,
``nvidia_smi``: ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``), and rank 0's kernel launches in the GMG
phase and in each distributed phase (``rank_kernel_launches``: the
wrappers of another process count them).

The sizes are ``FULL`` on any device; ``--smoke`` runs every phase at
tiny sizes (``SMOKE``), on the CPU with one thread.  With
``LEGATE_SPARSE_TPU_OBS=1`` the run also writes
``BENCH_<stamp>.trace.json`` (``LEGATE_SPARSE_TPU_OBS_FILE`` overrides
the path; it holds rank 0's spans and ``comm.*`` counters of the
distributed phases too) and exits non-zero if it holds no span.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np

# The phases' sizes (``bench.py``'s on the accelerator), and those of the
# --smoke lane: the same shapes cut to seconds on a CPU.
FULL = {"log2_rows": 24, "stream_lanes": 26, "cg_grid": 1024,
        "irregular_rows": 1 << 20, "bsr_rows": 1 << 13,
        "spgemm_rows": 1 << 20, "gmg_grid": 512, "cg_1m_grid": 1000,
        "pde_grid": 4096, "dist_log2_rows": 22, "dist2d_log2_rows": 20,
        "dist_k_hi": 16, "dist_cg_iters": 25, "engine_rows": 1 << 16,
        "recovery_rows": 1 << 16, "graph_scale": 13,
        "saturation_levels": (1, 2, 4, 8, 16), "saturation_per_client": 8,
        "serve_rows": 1 << 14, "autotune_rows": 1 << 18,
        "autotune_nnz_per_row": 8}
SMOKE = {"log2_rows": 12, "stream_lanes": 20, "cg_grid": 32,
         "irregular_rows": 1 << 12, "bsr_rows": 1 << 10,
         "spgemm_rows": 1 << 12, "gmg_grid": 32, "cg_1m_grid": 32,
         "pde_grid": 64, "dist_log2_rows": 12, "dist2d_log2_rows": 10,
         "dist_k_hi": 8, "dist_cg_iters": 8, "engine_rows": 1 << 12,
         "recovery_rows": 1 << 12, "graph_scale": 9,
         "saturation_levels": (1, 2, 4, 8), "saturation_per_client": 4,
         "serve_rows": 1 << 12, "autotune_rows": 1 << 10,
         "autotune_nnz_per_row": 4}
# bench.py's smoke forces exactly 8 devices: dist_shards and every comm
# byte count of its golden depend on it.
SMOKE_RANKS = 8
SCHEMA_VERSION = 20
BSR_DENSITY = 0.05
NNZ_PER_ROW = 11
SOLVE_SAMPLES = 5
# The recovery drill's budget, checkpoint cadence and lost rank.
RECOVERY_MAXITER, RECOVERY_CADENCE, RECOVERY_LOST = 40, 10, 1
GRAPH_SEED, PAGERANK_ITERS = 1234, 20
MUTATION_SEED = 23
# The gateway settings of bench.py's gateway, attrib, placement and
# mutation phases (each also sets max_batch and tenant_quota).
GATEWAY_KW = dict(queue_depth=128, rate=0.0, burst=16.0, slack_ms=5.0,
                  timeout_ms=0.0)
# The headline fields, each a number (``bench.py``'s names); with the
# strings ``path`` and the ``*_grid``s they are what every full run
# prints.  ``vs_baseline`` and ``mem_device_peak_mb`` are null on the CPU.
HEADLINE_NUMBERS = (
    "value", "vs_baseline", "stream_gbs", "spmv_ms", "spmv_bytes_per_nnz",
    "spmv_bytes_per_nnz_bf16", "obs_overhead_pct", "cg_ms_per_iter",
    "irregular_gbs", "irregular_frac", "bsr_ms", "bsr_gbs",
    "bsr_stream_gbs", "spgemm_n", "spgemm_ms", "spgemm_scipy_ms",
    "spgemm_vs_scipy", "gmg_cycle_ms", "gmg_cg_ms_per_iter", "cg_1m_rows",
    "cg_1m_ms_per_iter", "pde_ms_per_iter", "pde_bytes_per_iter",
    "pde_ms_per_iter_bf16", "pde_bytes_per_iter_bf16", "pde_bytes_ratio",
    "pde_stream_bound_ms", "pde_roofline_ratio", "bf16_ms", "bf16_gbs",
    "mem_peak_rss_mb", "mem_device_peak_mb", "bench_wall_s")
HEADLINE_STRINGS = ("metric", "unit", "platform", "path", "cg_grid",
                    "gmg_grid", "pde_grid")
# The numeric fields of the twelve phases ported from bench.py, by
# phase; the recovery fields are written only on 2 ranks or more.
PHASE_NUMBERS = {
    "dist": ("dist_shards", "dist_spmv_comm_bytes", "dist_spmv_ms",
             "dist_cg_iters", "dist_cg_comm_bytes", "comm_total_bytes"),
    "dist2d": ("dist2d_spmv_1d_comm_bytes", "dist2d_spgemm_1d_comm_bytes",
               "dist2d_spmv_comm_bytes", "dist2d_spmv_ms",
               "dist2d_spmv_comm_bytes_bf16", "dist2d_cg_iters",
               "dist2d_cg_comm_bytes", "dist2d_spgemm_comm_bytes"),
    "engine": ("engine_cold_ms", "engine_warm_ms", "engine_warm_speedup",
               "engine_batched_ms_per_req", "engine_batch_requests",
               "engine_plan_hits", "engine_plan_misses"),
    "resil": ("resil_clean_ms", "resil_recovered_ms",
              "resil_recovery_delta_ms", "resil_retries", "resil_shed",
              "resil_breaker_trips", "resil_faults_injected"),
    "recovery": ("recovery_clean_ms", "recovery_recovered_ms",
                 "resil_ckpt_saves", "resil_recoveries", "resil_restored",
                 "resil_reshard_bytes"),
    "graph": ("graph_n", "graph_nnz", "graph_bfs_iters",
              "graph_bfs_comm_bytes", "graph_sssp_iters",
              "graph_sssp_comm_bytes", "graph_cc_iters",
              "graph_cc_comm_bytes", "graph_pagerank_iters",
              "graph_pagerank_comm_bytes", "graph_ms"),
    "saturation": ("saturation_p50_ms", "saturation_p99_ms",
                   "saturation_requests", "saturation_shed",
                   "saturation_batched_requests"),
    "gateway": ("gateway_requests", "gateway_dispatches", "gateway_packed",
                "gateway_rejected_queue_full", "gateway_interactive_served",
                "gateway_interactive_shed", "gateway_batch_served",
                "gateway_background_served", "gateway_background_shed"),
    "attrib": ("attrib_requests", "attrib_packed", "attrib_tenants",
               "attrib_conserved", "attrib_comm_bytes",
               "attrib_tenant_comm_bytes", "attrib_ms"),
    "placement": ("placement_migrations", "placement_reshard_bytes",
                  "placement_routes", "placement_noisy_served",
                  "placement_quiet_served", "placement_ms"),
    "mutation": ("mutation_updates", "mutation_applied", "mutation_merged",
                 "mutation_compactions", "mutation_version_swaps",
                 "mutation_served", "mutation_routes", "mutation_ms",
                 "mutation_compaction_ms"),
    "autotune": ("irregular_spmv_ms", "irregular_csr_ms",
                 "irregular_spmv_speedup", "irregular_spmv_n",
                 "irregular_spmv_nnz", "autotune_verdicts"),
}
PHASE_STRINGS = ("dist2d_layout", "dist2d_grid", "irregular_spmv_path")


def _banded_config(sparse, n: int, nnz_per_row: int, dtype=np.float32,
                   device=None):
    """``nnz_per_row`` diagonals of 1/nnz_per_row: row sums of 1.0 keep
    the chained ``x_{t+1} = A @ x_t`` magnitude-stable."""
    half = nnz_per_row // 2
    offsets = list(range(-half, half + 1))
    val = np.float32(1.0 / nnz_per_row)
    diagonals = [np.full(n - abs(o), val, dtype=np.float32)
                 for o in offsets]
    return sparse.diags(diagonals, offsets, shape=(n, n), format="csr",
                        dtype=dtype, device=device)


def _irregular_config(sparse, n: int, nnz_per_row: int, device=None):
    """Random-sparsity CSR with skewed row lengths from ``default_rng(0)``:
    one heavy row defeats the band and ELL detection."""
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 2 * nnz_per_row, size=n).astype(np.int64)
    counts[0] = min(64 * nnz_per_row, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, n, size=nnz).astype(np.int32)
    row_ids = np.repeat(np.arange(n), counts)
    order = np.lexsort((indices, row_ids))
    indices = indices[order]
    data = np.ones(nnz, dtype=np.float32)
    return sparse.csr_array((data, indices, indptr), shape=(n, n),
                            device=device)


def _engine_config(sparse, n: int, nnz_per_row: int, seed: int = 7,
                   device=None):
    """Random-column CSR with one heavy row and ``nnz = nnz_per_row * (n
    + 63)`` exactly, from ``default_rng(seed)``: no band, over the ELL
    and BSR budgets, so the engine takes it; the seed moves the columns
    and values, never the nnz, so two seeds fall in one shape bucket."""
    rng = np.random.default_rng(seed)
    counts = np.full(n, nnz_per_row, dtype=np.int64)
    counts[0] = min(64 * nnz_per_row, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, n, size=nnz).astype(np.int32)
    row_ids = np.repeat(np.arange(n), counts)
    order = np.lexsort((indices, row_ids))
    indices = indices[order]
    data = rng.standard_normal(nnz).astype(np.float32)
    return sparse.csr_array((data, indices, indptr), shape=(n, n),
                            device=device)


def _dist2d_config(sparse, n: int, nnz_per_row: int, seed: int = 7,
                   device=None):
    """``A + A^T + 2I`` of a random COO (``default_rng(seed)``, ``n *
    nnz_per_row // 2`` draws), built by scipy: no band, so the 1-d layout
    gathers all of x, and diagonally dominated for the CG drill."""
    import scipy.sparse as sp_host

    rng = np.random.default_rng(seed)
    nnz = n * max(nnz_per_row // 2, 1)
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.standard_normal(nnz).astype(np.float32) / nnz_per_row
    A = sp_host.coo_array((vals, (rows, cols)), shape=(n, n)).tocsr()
    A = (A + A.T + 2.0 * sp_host.eye(n, format="csr")).tocsr()
    return sparse.csr_array(
        (A.data.astype(np.float32), A.indices.astype(np.int32), A.indptr),
        shape=A.shape, device=device)


def _poisson_f32(grid: int, device):
    """The 5-point Poisson operator on a ``grid``^2 grid in f32: the
    entries of ``bench.py``'s (its zero couplings across grid rows are
    dropped by the CSR conversion there too)."""
    from legate_sparse_tpu_torch.apps.common import poisson2D

    return poisson2D(grid, device=device, dtype=np.float32)


def _bsr_config(sparse, n: int, device):
    """The BSR phase's input: scipy's ``random(n, n, density=0.05)`` (f32,
    ``default_rng(1)``) on ``device``, and its block structure
    (``ops/bsr.py::build_structure``)."""
    import scipy.sparse as sp_host

    from legate_sparse_tpu_torch.ops.bsr import build_structure

    A_sp = sp_host.random(n, n, density=BSR_DENSITY, format="csr",
                          random_state=np.random.default_rng(1),
                          dtype=np.float32)
    A = sparse.csr_array(A_sp, device=device)
    st = build_structure(A.data, A.indices, A.indptr, A._get_row_ids(),
                         A.shape, max_expand=1e9)
    if st is None:
        raise RuntimeError("bsr: the block structure is over budget")
    return A, st


def _spmv_bytes(A, x) -> int:
    """Bytes one ``A @ x`` moves on the path it takes (the caches its
    dispatch builds, then ``csr_array.spmv_traffic_bytes``)."""
    _ = A @ x
    return A.spmv_traffic_bytes(x, path=A.spmv_path)


def _delta_ms_per_iter(device, run, k_lo: int, k_hi: int) -> dict:
    """ms per iteration of a solve ``run(maxiter)``: ``SOLVE_SAMPLES``
    differences of a ``k_hi`` and a ``k_lo`` run (interleaved, after one
    warm-up of each, the device synchronised around each run) over
    ``k_hi - k_lo``; their median and spread."""
    from legate_sparse_tpu_torch.apps.common import TorchTimer

    timer = TorchTimer(device)
    run(k_lo)
    run(k_hi)
    samples = []
    for _ in range(SOLVE_SAMPLES):
        timer.start()
        run(k_lo)
        t_lo = timer.stop()
        timer.start()
        run(k_hi)
        t_hi = timer.stop()
        samples.append((t_hi - t_lo) / (k_hi - k_lo))
    med = statistics.median(samples)
    if not med > 0:
        raise RuntimeError(f"unresolvable solve timing: {samples} ms/iter")
    return {"median": med, "min": min(samples), "max": max(samples),
            "samples": samples}


def _smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out[0]


def _gmg_rank(rank, world, grid: int, levels: int) -> dict:
    """The GMG phase on its rank: ``DistGMG`` on the ``grid``^2 Poisson
    operator, a chained V-cycle's ms and GMG-CG's ms per iteration."""
    import torch

    from legate_sparse_tpu_torch import parallel as P, runtime
    from legate_sparse_tpu_torch.apps.common import TorchTimer
    from legate_sparse_tpu_torch.bench_timing import loop_ms_per_iter
    from legate_sparse_tpu_torch.parallel import dist_csr as D
    from legate_sparse_tpu_torch.parallel.mesh import device_type

    if device_type() == "cpu":
        runtime.set_device("cpu")
    dev = runtime.default_device()
    ng = grid * grid
    A = _poisson_f32(grid, dev)
    mesh = P.make_row_mesh()
    dA = P.shard_csr(A, mesh=mesh)
    timer = TorchTimer(dev)
    timer.start()
    gmg = P.DistGMG(dA, levels=levels)
    build_s = timer.stop() / 1e3
    b = np.ones(ng, np.float32)
    bs = D.shard_vector(b, mesh, dA.rows_padded).to_local()

    def cycle_step(v):
        y = gmg.cycle(v)
        return y * torch.rsqrt(torch.mean(y * y) + 1e-20)

    cycle_ms = loop_ms_per_iter(cycle_step, bs, k_lo=3, k_hi=13)
    cg = _delta_ms_per_iter(
        dev, lambda k: P.dist_cg(dA, b, M=gmg.cycle, rtol=0.0, maxiter=k),
        20, 60)
    return {"cycle_ms": cycle_ms, "cg": cg, "build_s": build_s,
            "cycle_comm_bytes": gmg.cycle_comm_bytes,
            "launches": _kernel_launches()}


def _kernel_launches() -> dict:
    """Each kernel's CUDA launches in this process, by kernel name."""
    from legate_sparse_tpu_torch.ops import kernel_wrappers

    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _fetch(y) -> float:
    """The first value of ``y`` on the host (this rank's block of a
    sharded vector): the synchronising read ``bench.py`` makes after
    each timed call."""
    if hasattr(y, "to_local"):
        y = y.to_local()
    return float(y.reshape(-1)[0])


def _slowest_rank(dev):
    """Each rank's seconds -> the slowest rank's (an all-reduce): the
    ``agree`` of ``loop_ms_per_iter`` on the job's ranks, so that every
    rank chains the same number of collective steps."""
    import torch
    import torch.distributed as dist

    def agree(seconds: float) -> float:
        t = torch.tensor([seconds], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    return agree


def _counter_deltas(names):
    """``name -> counter value`` now, and a function giving each named
    counter's movement since."""
    from legate_sparse_tpu_torch import obs

    c0 = {k: obs.counters.get(k) for k in names}
    return lambda name: int(obs.counters.get(name) - c0[name])


# ---- the distributed phases: every rank of one launch runs them -------

def _dist_phase(sparse, size, dev, mesh) -> dict:
    """``bench.py``'s dist phase: the band row-sharded, its SpMV's wire
    bytes and ms, and a fixed-iteration ``dist_cg``."""
    from legate_sparse_tpu_torch import obs, parallel as P
    from legate_sparse_tpu_torch.bench_timing import loop_ms_per_iter
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    R = mesh.size()
    n = 1 << size["dist_log2_rows"]
    out = {}
    with obs.span("bench.dist") as sp, obs.memory.watermark("bench.dist"):
        A = _banded_config(sparse, n, NNZ_PER_ROW, device=dev)
        dA = P.shard_csr(A, mesh=mesh)
        x = D.shard_vector(np.ones(n, np.float32), mesh, dA.rows_padded)
        _fetch(P.dist_spmv(dA, x))
        vols = D.spmv_comm_volumes(dA, dA.rows_padded // R, 4)
        out["dist_shards"] = R
        out["dist_spmv_comm_bytes"] = sum(vols.values())
        out["dist_spmv_ms"] = loop_ms_per_iter(
            lambda v: P.dist_spmv(dA, v), x.to_local(), k_lo=2,
            k_hi=size["dist_k_hi"], agree=_slowest_rank(dev))
        # rtol 0 never stops early: the iterations, and so the bytes,
        # are fixed.
        xs, it = P.dist_cg(dA, np.ones(n, np.float32), rtol=0.0,
                           maxiter=size["dist_cg_iters"])
        _fetch(xs)
        cg_vols, _calls = D.cg_comm_volumes(dA, 4, int(it))
        out["dist_cg_iters"] = int(it)
        out["dist_cg_comm_bytes"] = sum(cg_vols.values())
        if sp is not None:
            sp.set(shards=R, rows=n, comm_bytes=(
                out["dist_spmv_comm_bytes"] + out["dist_cg_comm_bytes"]))
    out["comm_total_bytes"] = int(obs.counters.get("comm.total_bytes"))
    return out


def _spgemm_wire_bytes() -> int:
    from legate_sparse_tpu_torch import obs

    return sum(v for k, v in obs.counters.snapshot().items()
               if k.startswith("comm.dist_spgemm.") and k.endswith("_bytes"))


def _dist2d_phase(sparse, size, dev, mesh) -> dict:
    """``bench.py``'s dist2d phase: a random symmetric matrix on the 1-d
    row mesh (the baselines) and on the grid mesh through the
    byte-predicting router; SpMV, its bf16 ``compress()`` twin, CG and
    SpGEMM."""
    import torch

    from legate_sparse_tpu_torch import obs, parallel as P
    from legate_sparse_tpu_torch.bench_timing import loop_ms_per_iter
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    n = 1 << size["dist2d_log2_rows"]
    grid_mesh = P.make_grid_mesh()
    gr = tuple(int(d) for d in grid_mesh.shape)
    out = {}
    with obs.span("bench.dist2d") as sp, \
            obs.memory.watermark("bench.dist2d"):
        A = _dist2d_config(sparse, n, NNZ_PER_ROW, device=dev)
        dA1 = P.shard_csr(A, mesh=mesh)
        vols1 = D.spmv_comm_volumes(dA1, dA1.rows_padded // dA1.num_shards,
                                    4)
        out["dist2d_spmv_1d_comm_bytes"] = sum(vols1.values())
        led0 = _spgemm_wire_bytes()
        C1 = P.dist_spgemm(dA1, dA1)
        out["dist2d_spgemm_1d_comm_bytes"] = _spgemm_wire_bytes() - led0
        del C1, dA1
        dA2 = P.shard_csr(A, mesh=grid_mesh, layout="auto")
        out["dist2d_layout"] = dA2.layout
        out["dist2d_grid"] = f"{gr[0]}x{gr[1]}"
        vols2 = D.spmv_comm_volumes(dA2, dA2.rows_padded // dA2.num_shards,
                                    4)
        out["dist2d_spmv_comm_bytes"] = sum(vols2.values())
        x = D.shard_vector(np.ones(n, np.float32), grid_mesh,
                           dA2.rows_padded, layout=dA2.layout)
        _fetch(P.dist_spmv(dA2, x))
        out["dist2d_spmv_ms"] = loop_ms_per_iter(
            lambda v: P.dist_spmv(dA2, v), x.to_local(), k_lo=2,
            k_hi=size["dist_k_hi"], agree=_slowest_rank(dev))
        # The compressed panels (bf16 values, int16 local indices) with
        # a bf16 x, priced by the same formulas at itemsize 2.
        dC2 = P.shard_csr(A.compress(), mesh=grid_mesh, layout=dA2.layout)
        volsb = D.spmv_comm_volumes(dC2, dC2.rows_padded // dC2.num_shards,
                                    2)
        out["dist2d_spmv_comm_bytes_bf16"] = sum(volsb.values())
        xb = D.shard_vector(torch.ones(n, dtype=torch.bfloat16, device=dev),
                            grid_mesh, dC2.rows_padded, layout=dC2.layout)
        _fetch(P.dist_spmv(dC2, xb))
        del dC2, xb
        xs, it = P.dist_cg(dA2, np.ones(n, np.float32), rtol=0.0,
                           maxiter=size["dist_cg_iters"])
        _fetch(xs)
        cg_vols, _calls = D.cg_comm_volumes(dA2, 4, int(it))
        out["dist2d_cg_iters"] = int(it)
        out["dist2d_cg_comm_bytes"] = sum(cg_vols.values())
        led1 = _spgemm_wire_bytes()
        C2 = P.dist_spgemm(dA2, dA2)
        out["dist2d_spgemm_comm_bytes"] = _spgemm_wire_bytes() - led1
        del C2
        if sp is not None:
            sp.set(grid=gr, layout=dA2.layout, comm_bytes=(
                out["dist2d_spmv_comm_bytes"] + out["dist2d_cg_comm_bytes"]))
    out["comm_total_bytes"] = int(obs.counters.get("comm.total_bytes"))
    return out


def _recovery_phase(sparse, size, dev, mesh, rank: int) -> dict:
    """``bench.py``'s recovery phase (2 ranks or more, as its gate): a
    ``device_loss`` of rank ``RECOVERY_LOST`` at the second convergence
    fetch of a checkpointed ``dist_cg``; the survivors reshard onto the
    survivor mesh, restore the last snapshot and finish the budget.
    The lost rank leaves the solve with the typed ``DeviceLost``, the
    drill's outcome for it; any other rank's failure ends the run."""
    from legate_sparse_tpu_torch import obs, parallel as P, resilience
    from legate_sparse_tpu_torch.settings import settings

    if mesh.size() < 2:
        return {}
    n = size["recovery_rows"]
    kw = {"rtol": 0.0, "maxiter": RECOVERY_MAXITER,
          "conv_test_iters": RECOVERY_CADENCE}
    saved = (settings.resil, settings.resil_ckpt_iters,
             settings.resil_backoff_ms)
    out = {}
    with obs.span("bench.recovery") as sp:
        try:
            settings.resil = True
            settings.resil_ckpt_iters = RECOVERY_CADENCE
            settings.resil_backoff_ms = 0.0
            resilience.reset()
            dA = P.shard_csr(_banded_config(sparse, n, NNZ_PER_ROW,
                                            device=dev), mesh=mesh)
            b = np.ones(n, np.float32)
            P.dist_cg(dA, b, **kw)
            _sync(dev)
            t0 = time.perf_counter()
            _fetch(P.dist_cg(dA, b, **kw)[0])
            clean_ms = (time.perf_counter() - t0) * 1e3
            moved = _counter_deltas((
                "resil.ckpt.saves", "resil.recovery.attempts",
                "resil.recovery.restored_iters",
                "resil.recovery.reshard_bytes"))
            resilience.inject("solver.cg.conv", "device_loss", after=2,
                              device=RECOVERY_LOST)
            t0 = time.perf_counter()
            try:
                xs, it = P.dist_cg(dA, b, **kw)
            except resilience.DeviceLost:
                if rank != RECOVERY_LOST:
                    raise
                return {}
            _fetch(xs)
            out["recovery_clean_ms"] = clean_ms
            out["recovery_recovered_ms"] = (time.perf_counter() - t0) * 1e3
            out["resil_ckpt_saves"] = moved("resil.ckpt.saves")
            out["resil_recoveries"] = moved("resil.recovery.attempts")
            out["resil_restored"] = moved("resil.recovery.restored_iters")
            out["resil_reshard_bytes"] = moved(
                "resil.recovery.reshard_bytes")
            if sp is not None:
                sp.set(saves=out["resil_ckpt_saves"],
                       recoveries=out["resil_recoveries"],
                       reshard_bytes=out["resil_reshard_bytes"],
                       iters=int(it))
        finally:
            (settings.resil, settings.resil_ckpt_iters,
             settings.resil_backoff_ms) = saved
            resilience.reset()
    return out


def _graph_phase(sparse, size, dev) -> dict:
    """``bench.py``'s graph phase: the four semiring algorithms on one
    seeded R-MAT graph over the row mesh of every rank; each one's
    sweeps and the comm ledger's bytes around it."""
    from legate_sparse_tpu_torch import gallery, graph, obs

    A = gallery.rmat(size["graph_scale"], nnz_per_row=4,
                    rng=np.random.default_rng(GRAPH_SEED), directed=True,
                    device=dev)
    out = {"graph_n": int(A.shape[0]), "graph_nnz": int(A.nnz)}
    runs = (("bfs", lambda: graph.bfs(A, source=0)),
            ("sssp", lambda: graph.sssp(A, source=0)),
            ("cc", lambda: graph.connected_components(A)),
            ("pagerank", lambda: graph.pagerank(A, tol=0.0,
                                                max_iters=PAGERANK_ITERS)))
    with obs.span("bench.graph") as sp:
        t0 = time.perf_counter()
        for name, run in runs:
            moved = _counter_deltas((f"graph.{name}.iters",
                                     "comm.total_bytes"))
            run()
            _sync(dev)
            out[f"graph_{name}_iters"] = moved(f"graph.{name}.iters")
            out[f"graph_{name}_comm_bytes"] = moved("comm.total_bytes")
        out["graph_ms"] = (time.perf_counter() - t0) * 1e3
        if sp is not None:
            sp.set(n=out["graph_n"], nnz=out["graph_nnz"],
                   bfs_iters=out["graph_bfs_iters"],
                   pagerank_iters=out["graph_pagerank_iters"])
    return out


ATTRIB_TENANTS = ("interactive", "batch", "background")


def _attrib_wire_phase(sparse, size, dev, mesh) -> dict:
    """The wire half of ``bench.py``'s attrib phase: two ``dist_spmv``
    of a band with attribution armed, one under a single tenant's trace
    context, one under a 3-member scope; conserved when the per-tenant
    bytes (the untagged sink included), the attributed total and the
    comm ledger's delta are one number above 0."""
    from legate_sparse_tpu_torch import obs, parallel as P
    from legate_sparse_tpu_torch.obs import attrib, context
    from legate_sparse_tpu_torch.parallel import dist_csr as D
    from legate_sparse_tpu_torch.settings import settings

    targets = ATTRIB_TENANTS + ("__untagged__",)
    out = {}
    t0 = time.perf_counter()
    with obs.span("bench.attrib") as sp:
        moved = _counter_deltas(
            ["comm.total_bytes", "attrib.total.comm_bytes"]
            + [f"attrib.tenant.{t}.comm_bytes" for t in targets])
        saved = settings.obs_attrib
        try:
            settings.obs_attrib = True
            n = size["serve_rows"]
            dA = P.shard_csr(_banded_config(sparse, n, NNZ_PER_ROW,
                                            device=dev), mesh=mesh)
            x = D.shard_vector(np.ones(n, np.float32), mesh, dA.rows_padded)
            with context.use(context.TraceContext(
                    "bench-attrib-one", tenant="interactive",
                    qos="interactive")):
                _fetch(P.dist_spmv(dA, x))
            with attrib.scope([(t, t) for t in ATTRIB_TENANTS]):
                _fetch(P.dist_spmv(dA, x))
        finally:
            settings.obs_attrib = saved
        comm = moved("comm.total_bytes")
        tenant_bytes = sum(moved(f"attrib.tenant.{t}.comm_bytes")
                           for t in targets)
        out["attrib_comm_bytes"] = comm
        out["attrib_tenant_comm_bytes"] = tenant_bytes
        out["attrib_tenants"] = sum(
            1 for t in ATTRIB_TENANTS
            if moved(f"attrib.tenant.{t}.comm_bytes"))
        out["attrib_conserved"] = int(
            tenant_bytes == moved("attrib.total.comm_bytes") == comm
            and comm > 0)
        if sp is not None:
            sp.set(comm_bytes=comm, conserved=out["attrib_conserved"])
    out["attrib_wire_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def _placement_phase(sparse, size, dev) -> dict:
    """``bench.py``'s placement phase: two placed tenants served through
    the gateway on the plain local path, a carve ``propose``d over a
    FIXED snapshot (the noisy tenant burning) and applied, so each rank
    makes the same moves, then a second round on the new carve."""
    import torch

    from legate_sparse_tpu_torch import obs, placement
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.engine.gateway import QOS_WEIGHTS
    from legate_sparse_tpu_torch.settings import settings

    t0 = time.perf_counter()
    n = size["serve_rows"] - 91
    out = {}
    with obs.span("bench.placement") as sp:
        A1 = _engine_config(sparse, n, NNZ_PER_ROW, device=dev)
        A2 = _engine_config(sparse, n, NNZ_PER_ROW, seed=13, device=dev)
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        moved = _counter_deltas((
            "placement.migrations", "placement.migration.bytes",
            "placement.routes", "gateway.tenant.noisy.served",
            "gateway.tenant.quiet.served"))
        saved = (settings.gateway, settings.placement)
        try:
            settings.gateway = True
            settings.placement = True
            placement.reset()
            placement.place("noisy", A1)
            placement.place("quiet", A2)

            def load(gw, n_noisy, n_quiet):
                futs = [gw.submit(A1, x, tenant="noisy", qos="interactive")
                        for _ in range(n_noisy)]
                futs += [gw.submit(A2, x, tenant="quiet", qos="background")
                         for _ in range(n_quiet)]
                gw.flush()
                for f in futs:
                    f.result(timeout=120)

            gw = Gateway(Engine(), max_batch=4, tenant_quota=64,
                         **GATEWAY_KW)
            try:
                load(gw, 16, 4)
                devs = placement.submesh.job_ranks()
                reg = placement.registry()
                snap = placement.PlacementSnapshot(
                    demand={"noisy": {"busy_ns": 8_000_000_000,
                                      "qos": "interactive"},
                            "quiet": {"busy_ns": 1_000_000_000,
                                      "qos": "background"}},
                    qos_weights=dict(QOS_WEIGHTS),
                    burns={"interactive": 1000.0}, devices=len(devs),
                    current=reg.slices(), payload_bytes=reg.payload_bytes(),
                    shrink=())
                decision = placement.propose(snap)
                if decision.act:
                    reg.apply(decision.moves, devs)
                # The first product on the new carve, outside the round.
                for tenant, A in (("noisy", A1), ("quiet", A2)):
                    _fetch(placement.route(A, tenant).dot(x))
                load(gw, 8, 2)
            finally:
                gw.shutdown()
        finally:
            settings.gateway, settings.placement = saved
            placement.reset()
        out["placement_migrations"] = moved("placement.migrations")
        out["placement_reshard_bytes"] = moved("placement.migration.bytes")
        out["placement_routes"] = moved("placement.routes")
        out["placement_noisy_served"] = moved("gateway.tenant.noisy.served")
        out["placement_quiet_served"] = moved("gateway.tenant.quiet.served")
        out["placement_ms"] = (time.perf_counter() - t0) * 1e3
        if sp is not None:
            sp.set(migrations=out["placement_migrations"],
                   reshard_bytes=out["placement_reshard_bytes"],
                   routes=out["placement_routes"])
    return out


def _rank_phases(rank, world, size: dict, trace: bool) -> dict:
    """The distributed phases on one rank of the job, in ``bench.py``'s
    order: dist, dist2d, recovery, graph, attrib's wire, placement.
    Every rank makes the same calls; rank 0's fields, phase seconds,
    spans (with ``trace``) and kernel launches a phase are the run's."""
    import torch.distributed as dist

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import obs, parallel as P, runtime
    from legate_sparse_tpu_torch.parallel.mesh import device_type

    if device_type() == "cpu":
        runtime.set_device("cpu")
    dev = runtime.default_device()
    if trace:
        obs.enable()
    mesh = P.make_row_mesh()
    fields, phase_s = {}, {}
    phases = (("dist", lambda: _dist_phase(sparse, size, dev, mesh)),
              ("dist2d", lambda: _dist2d_phase(sparse, size, dev, mesh)),
              ("recovery", lambda: _recovery_phase(sparse, size, dev, mesh,
                                                   rank)),
              ("graph", lambda: _graph_phase(sparse, size, dev)),
              ("attrib", lambda: _attrib_wire_phase(sparse, size, dev,
                                                    mesh)),
              ("placement", lambda: _placement_phase(sparse, size, dev)))
    launches = {}
    for name, phase in phases:
        t0 = time.perf_counter()
        before = _kernel_launches()
        fields.update(phase())
        launches[name] = {k: n - before[k]
                          for k, n in _kernel_launches().items()}
        # The lost rank of the recovery drill leaves the solve early.
        dist.barrier()
        phase_s[name] = time.perf_counter() - t0
    spans = ([r for r in obs.records() if r["type"] == "span"]
             if trace and rank == 0 else [])
    comm = ({k: v for k, v in obs.counters.snapshot().items()
             if k.startswith("comm.")} if trace and rank == 0 else {})
    return {"fields": fields, "phase_s": phase_s, "spans": spans,
            "comm_counters": comm, "launches": launches}


# ---- the serving phases: in the bench's own process ---------------------

def _engine_phase(sparse, size, dev) -> dict:
    """``bench.py``'s engine phase: a fresh engine's cold plan build, the
    warm cached plan on another n in the same bucket (best of 5), and 8
    requests stacked into one SpMM by a flush-only executor."""
    import torch

    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.engine import Engine, RequestExecutor

    n_cold = size["engine_rows"] - 37
    n_warm = size["engine_rows"] - 101
    out = {}
    with obs.span("bench.engine") as sp, \
            obs.memory.watermark("bench.engine"):
        A_cold = _engine_config(sparse, n_cold, NNZ_PER_ROW, device=dev)
        A_warm = _engine_config(sparse, n_warm, NNZ_PER_ROW, device=dev)
        x_cold = torch.ones((n_cold,), dtype=torch.float32, device=dev)
        x_warm = torch.ones((n_warm,), dtype=torch.float32, device=dev)
        eng = Engine()
        moved = _counter_deltas(("engine.plan.hits", "engine.plan.misses"))
        t0 = time.perf_counter()
        y = eng.matvec(A_cold, x_cold)
        if y is None:
            raise RuntimeError("bench_torch: the engine declined the "
                               "engine phase's matrix")
        _fetch(y)
        cold_ms = (time.perf_counter() - t0) * 1e3
        # One untimed hit builds A_warm's pack; the timed calls are the
        # cached plan alone.
        _fetch(eng.matvec(A_warm, x_warm))
        warm_ms = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            _fetch(eng.matvec(A_warm, x_warm))
            warm_ms = min(warm_ms, (time.perf_counter() - t0) * 1e3)
        ex = RequestExecutor(eng, max_batch=8, queue_depth=64, timeout_ms=0)
        reqs = 8
        try:
            t0 = time.perf_counter()
            futs = [ex.submit(A_warm, x_warm) for _ in range(reqs)]
            for f in futs:
                _fetch(f.result())
            batched_ms = (time.perf_counter() - t0) * 1e3 / reqs
        finally:
            ex.shutdown()
        out["engine_cold_ms"] = cold_ms
        out["engine_warm_ms"] = warm_ms
        out["engine_warm_speedup"] = cold_ms / max(warm_ms, 1e-9)
        out["engine_batched_ms_per_req"] = batched_ms
        out["engine_batch_requests"] = reqs
        out["engine_plan_hits"] = moved("engine.plan.hits")
        out["engine_plan_misses"] = moved("engine.plan.misses")
        if sp is not None:
            sp.set(nnz=A_cold.nnz + A_warm.nnz, cold_ms=cold_ms,
                   warm_ms=warm_ms)
    return out


def _resil_phase(sparse, size, dev) -> dict:
    """``bench.py``'s resil phase: a fail-twice fault on the ``csr.dot``
    site (2 retries), 3 consecutive faults that trip a K = 3 breaker
    and one short-circuited call, and an expired-deadline request shed
    by the executor; settings restored on exit."""
    import torch

    from legate_sparse_tpu_torch import obs, resilience
    from legate_sparse_tpu_torch.engine import Engine, RequestExecutor
    from legate_sparse_tpu_torch.resilience import deadline
    from legate_sparse_tpu_torch.settings import settings

    n = size["engine_rows"] - 57
    names = ("resil", "resil_retries", "resil_backoff_ms",
             "resil_breaker_k", "resil_breaker_cooldown_ms")
    saved = {k: getattr(settings, k) for k in names}
    out = {}
    with obs.span("bench.resil") as sp:
        try:
            settings.resil = True
            settings.resil_retries = 2
            settings.resil_backoff_ms = 0.0
            settings.resil_breaker_k = 3
            settings.resil_breaker_cooldown_ms = 50.0
            resilience.reset()
            moved = _counter_deltas((
                "resil.retry.attempts", "resil.shed", "resil.breaker.trips",
                "resil.fault.injected"))
            A = _engine_config(sparse, n, NNZ_PER_ROW, device=dev)
            x = torch.ones((n,), dtype=torch.float32, device=dev)
            _fetch(A.dot(x))
            t0 = time.perf_counter()
            _fetch(A.dot(x))
            clean_ms = (time.perf_counter() - t0) * 1e3
            # Drill 1: two failures, then the same call succeeds.
            resilience.inject("csr.dot", kind="error", count=2)
            t0 = time.perf_counter()
            _fetch(A.dot(x))
            recovered_ms = (time.perf_counter() - t0) * 1e3
            resilience.faults.clear()
            # Drill 2: K failures trip the breaker, which then fails the
            # next call fast; each raises the typed error the drill is
            # made of.
            settings.resil_retries = 0
            resilience.inject("csr.dot", kind="error", count=3)
            for _ in range(4):
                try:
                    A.dot(x)
                except resilience.ResilienceError:
                    pass
            resilience.faults.clear()
            settings.resil_retries = 2
            # Drill 3: a request whose deadline has passed is shed with
            # the typed Rejected outcome, never dispatched.
            ex = RequestExecutor(Engine(), max_batch=8, queue_depth=64,
                                 timeout_ms=0)
            try:
                with deadline.scope(0.0):
                    fut = ex.submit(A, x)
                shed = fut.result(timeout=10)
            finally:
                ex.shutdown()
            if type(shed).__name__ != "Rejected":
                raise RuntimeError(f"bench_torch: resil drill 3 gave "
                                   f"{type(shed).__name__}, not Rejected")
            out["resil_clean_ms"] = clean_ms
            out["resil_recovered_ms"] = recovered_ms
            out["resil_recovery_delta_ms"] = recovered_ms - clean_ms
            out["resil_retries"] = moved("resil.retry.attempts")
            out["resil_shed"] = moved("resil.shed")
            out["resil_breaker_trips"] = moved("resil.breaker.trips")
            out["resil_faults_injected"] = moved("resil.fault.injected")
            if sp is not None:
                sp.set(retries=out["resil_retries"], shed=out["resil_shed"],
                       trips=out["resil_breaker_trips"])
        finally:
            for k, v in saved.items():
                setattr(settings, k, v)
            resilience.reset()
    return out


def _saturation_phase(sparse, size, dev) -> dict:
    """``bench.py``'s saturation phase: closed-loop clients (threads
    that submit, wait, resubmit) at each concurrency level against one
    executor, every plan warmed first; p50/p99 from the
    ``lat.engine.request`` histograms, throughput and batch occupancy
    from the counters; then one pre-expired request shed."""
    import threading

    import torch

    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.engine import Engine, RequestExecutor
    from legate_sparse_tpu_torch.obs import latency
    from legate_sparse_tpu_torch.resilience import deadline
    from legate_sparse_tpu_torch.settings import settings

    n = size["engine_rows"] - 73
    levels = size["saturation_levels"]
    per_client = size["saturation_per_client"]
    out = {}
    with obs.span("bench.saturation") as sp:
        A = _engine_config(sparse, n, NNZ_PER_ROW, device=dev)
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        eng = Engine()
        ex = RequestExecutor(eng, max_batch=8, queue_depth=64,
                             timeout_ms=0.5)
        try:
            eng.warmup([{"op": "spmv", "rows": n, "nnz": A.nnz}]
                       + [{"op": "spmm", "rows": n, "nnz": A.nnz, "k": k}
                          for k in levels if 1 < k <= 8])
            _fetch(ex.submit(A, x).result(timeout=60))
            moved = _counter_deltas((
                "engine.exec.outcome.resolved",
                "engine.exec.batched_requests", "resil.shed"))
            sat = []
            for clients in levels:
                latency.reset("lat.engine.request")
                level = _counter_deltas(("engine.exec.batched_requests",
                                         "engine.exec.batches"))
                errors = []

                def client():
                    try:
                        for _ in range(per_client):
                            _fetch(ex.submit(A, x).result(timeout=120))
                    except Exception as e:   # re-raised after join
                        errors.append(e)

                threads = [threading.Thread(target=client)
                           for _ in range(clients)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t0
                if errors:
                    raise errors[0]
                merged = None
                for h in latency.snapshot("lat.engine.request").values():
                    merged = h if merged is None else merged.merge(h)
                reqs = clients * per_client
                sat.append({
                    "clients": clients, "requests": reqs,
                    "p50_ms": merged.quantile(0.5),
                    "p99_ms": merged.quantile(0.99),
                    "throughput_rps": reqs / max(wall, 1e-9),
                    "mean_batch_occupancy": (
                        level("engine.exec.batched_requests")
                        / max(level("engine.exec.batches"), 1)),
                    "shed": 0})
            saved = settings.resil
            try:
                settings.resil = True
                with deadline.scope(0.0):
                    fut = ex.submit(A, x)
                shed = fut.result(timeout=10)
            finally:
                settings.resil = saved
            if type(shed).__name__ != "Rejected":
                raise RuntimeError(f"bench_torch: saturation shed drill "
                                   f"gave {type(shed).__name__}")
        finally:
            ex.shutdown()
        out["saturation"] = sat
        out["saturation_requests"] = moved("engine.exec.outcome.resolved")
        out["saturation_shed"] = moved("resil.shed")
        out["saturation_batched_requests"] = moved(
            "engine.exec.batched_requests")
        out["saturation_p50_ms"] = sat[-1]["p50_ms"]
        out["saturation_p99_ms"] = sat[-1]["p99_ms"]
        if sp is not None:
            sp.set(levels=len(levels), requests=out["saturation_requests"],
                   p99_ms=out["saturation_p99_ms"])
    return out


def _gateway_phase(sparse, size, dev) -> dict:
    """``bench.py``'s gateway phase, a 3-tenant load in two stages:
    stage A (``max_batch`` 4) packs the interactive tenant's two
    alternating matrices into stacked dispatches; stage B (flush-only,
    a tenant quota of 8) rejects 24 of the background tenant's 32
    requests as ``queue_full``."""
    import torch

    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.settings import settings

    n = size["serve_rows"] - 91
    names = ("gateway.submitted", "gateway.dispatches", "gateway.packed",
             "gateway.rejected.queue_full",
             "gateway.tenant.interactive.served",
             "gateway.tenant.interactive.shed",
             "gateway.tenant.batch.served",
             "gateway.tenant.background.served",
             "gateway.tenant.background.shed")
    with obs.span("bench.gateway") as sp:
        A1 = _engine_config(sparse, n, NNZ_PER_ROW, device=dev)
        A2 = _engine_config(sparse, n, NNZ_PER_ROW, seed=13, device=dev)
        A3 = _engine_config(sparse, n, NNZ_PER_ROW, seed=29, device=dev)
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        moved = _counter_deltas(names)
        saved = settings.gateway
        try:
            settings.gateway = True

            def load(gw):
                futs = [gw.submit(A1 if i % 2 == 0 else A2, x,
                                  tenant="interactive", qos="interactive")
                        for i in range(8)]
                futs += [gw.submit(A3, x, tenant="batch", qos="batch")
                         for _ in range(8)]
                futs += [gw.submit(A1, x, tenant="background",
                                   qos="background") for _ in range(32)]
                gw.flush()
                for f in futs:
                    f.result(timeout=120)

            for max_batch, quota in ((4, 64), (32, 8)):
                gw = Gateway(Engine(), max_batch=max_batch,
                             tenant_quota=quota, **GATEWAY_KW)
                try:
                    load(gw)
                finally:
                    gw.shutdown()
        finally:
            settings.gateway = saved
        out = {"gateway_requests": moved("gateway.submitted"),
               "gateway_dispatches": moved("gateway.dispatches"),
               "gateway_packed": moved("gateway.packed"),
               "gateway_rejected_queue_full": moved(
                   "gateway.rejected.queue_full")}
        for tenant, what in (("interactive", "served"),
                             ("interactive", "shed"), ("batch", "served"),
                             ("background", "served"),
                             ("background", "shed")):
            out[f"gateway_{tenant}_{what}"] = moved(
                f"gateway.tenant.{tenant}.{what}")
        if sp is not None:
            sp.set(requests=out["gateway_requests"],
                   packed=out["gateway_packed"],
                   rejected=out["gateway_rejected_queue_full"])
    return out


def _attrib_load_phase(sparse, size, dev) -> dict:
    """The serving half of ``bench.py``'s attrib phase: a 2-tenant
    gateway load with attribution armed, the interactive tenant's
    alternating matrices packed into multi-tenant batches.  (On a job
    of several ranks the engine serves no matrix, so the load runs in
    this process; its dispatches move no wire bytes.)"""
    import torch

    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.settings import settings

    t0 = time.perf_counter()
    n = size["serve_rows"] - 91
    with obs.span("bench.attrib") as sp:
        A1 = _engine_config(sparse, n, NNZ_PER_ROW, device=dev)
        A2 = _engine_config(sparse, n, NNZ_PER_ROW, seed=13, device=dev)
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        moved = _counter_deltas(("gateway.submitted", "gateway.packed"))
        saved = (settings.gateway, settings.obs_attrib)
        try:
            settings.gateway = True
            settings.obs_attrib = True
            gw = Gateway(Engine(), max_batch=4, tenant_quota=64,
                         **GATEWAY_KW)
            try:
                futs = [gw.submit(A1 if i % 2 == 0 else A2, x,
                                  tenant="interactive", qos="interactive")
                        for i in range(8)]
                futs += [gw.submit(A2, x, tenant="batch", qos="batch")
                         for _ in range(8)]
                gw.flush()
                for f in futs:
                    f.result(timeout=120)
            finally:
                gw.shutdown()
        finally:
            settings.gateway, settings.obs_attrib = saved
        out = {"attrib_requests": moved("gateway.submitted"),
               "attrib_packed": moved("gateway.packed")}
        if sp is not None:
            sp.set(requests=out["attrib_requests"])
    out["attrib_load_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def _mutation_phase(sparse, size, dev) -> dict:
    """``bench.py``'s mutation phase: a ``DeltaCSR`` served through the
    gateway's delta route while ``gallery.mutation_stream`` (seed 23,
    100 updates in batches of 10) lands in its buffer, then one
    compaction with its version swap and a round on the merged base."""
    import torch

    from legate_sparse_tpu_torch import gallery, obs
    from legate_sparse_tpu_torch.delta import DeltaCSR
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.settings import settings

    t0 = time.perf_counter()
    n = size["serve_rows"] - 91
    names = ("delta.updates", "delta.applied", "delta.compaction.merged",
             "delta.compactions", "delta.swap.versions", "delta.served",
             "delta.routes")
    with obs.span("bench.mutation") as sp:
        A = _engine_config(sparse, n, NNZ_PER_ROW, seed=29, device=dev)
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        moved = _counter_deltas(names)
        saved = (settings.gateway, settings.delta)
        try:
            settings.gateway = True
            settings.delta = True
            D = DeltaCSR(A, capacity=256)
            gw = Gateway(Engine(), max_batch=4, tenant_quota=64,
                         **GATEWAY_KW)
            try:
                def serve(k):
                    futs = [gw.submit(D, x, tenant="mut", qos="interactive")
                            for _ in range(k)]
                    gw.flush()
                    for f in futs:
                        f.result(timeout=120)

                # The base alone, then base and buffer, outside the
                # serving rounds.
                _fetch(D.dot(x))
                D.update([0], [0], [1.0])
                _fetch(D.dot(x))
                for rows, cols, vals in gallery.mutation_stream(
                        MUTATION_SEED, A, 100, batch=10):
                    D.update(rows, cols, vals)
                    serve(2)
                t_c = time.perf_counter()
                D.compact()
                compaction_ms = (time.perf_counter() - t_c) * 1e3
                serve(4)
            finally:
                gw.shutdown()
        finally:
            settings.gateway, settings.delta = saved
        out = {"mutation_updates": moved("delta.updates"),
               "mutation_applied": moved("delta.applied"),
               "mutation_merged": moved("delta.compaction.merged"),
               "mutation_compactions": moved("delta.compactions"),
               "mutation_version_swaps": moved("delta.swap.versions"),
               "mutation_served": moved("delta.served"),
               "mutation_routes": moved("delta.routes"),
               "mutation_compaction_ms": compaction_ms,
               "mutation_ms": (time.perf_counter() - t0) * 1e3}
        if sp is not None:
            sp.set(updates=out["mutation_updates"],
                   merged=out["mutation_merged"],
                   swaps=out["mutation_version_swaps"])
    return out


def _autotune_phase(sparse, size, dev, smoke: bool) -> dict:
    """``bench.py``'s autotune phase: a seeded power-law matrix's SpMV
    verdict (measured; pinned to ``sliced-ell`` under ``--smoke``, so
    its count is exact), one eager product that must route through it,
    and the sliced ELL raced against csr-rowids (``loop_ms_per_iter``,
    90 s a kernel at most); the verdict store restored on exit."""
    import torch

    from legate_sparse_tpu_torch import autotune, gallery, obs
    from legate_sparse_tpu_torch.bench_timing import loop_ms_per_iter
    from legate_sparse_tpu_torch.ops import spmv as spmv_ops
    from legate_sparse_tpu_torch.settings import settings

    n = size["autotune_rows"]
    saved = settings.autotune
    out = {}
    with obs.span("bench.autotune") as sp, \
            obs.memory.watermark("bench.autotune"):
        try:
            autotune.reset()
            settings.autotune = True
            A = gallery.powerlaw(n, nnz_per_row=size["autotune_nnz_per_row"],
                                rng=11, device=dev)
            A.sum_duplicates()
            x = torch.ones((n,), dtype=A.dtype, device=dev)
            moved = _counter_deltas(("autotune.verdict.records",
                                     "autotune.route.hits"))
            if smoke:
                autotune.get_store().record(autotune.key_for(A, "spmv"),
                                            "sliced-ell", {})
                label = "sliced-ell"
            else:
                label = autotune.tune(A, x).label
            _fetch(A @ x)
            if moved("autotune.route.hits") <= 0:
                raise RuntimeError("bench_torch: the autotune verdict did "
                                   "not route the product")
            bins, rid = A._get_sliced_ell(), A._get_row_ids()
            kw = dict(k_lo=2 if smoke else 5, k_hi=4 if smoke else None,
                      deadline_s=None if smoke else 90.0)
            sliced_ms = loop_ms_per_iter(
                lambda v: spmv_ops.sliced_ell_spmv(bins, v, n), x, **kw)
            csr_ms = loop_ms_per_iter(
                lambda v: spmv_ops.csr_spmv_rowids(A.data, A.indices, rid,
                                                   v, n), x, **kw)
            out["irregular_spmv_n"] = n
            out["irregular_spmv_nnz"] = A.nnz
            out["irregular_spmv_ms"] = sliced_ms
            out["irregular_csr_ms"] = csr_ms
            out["irregular_spmv_speedup"] = csr_ms / max(sliced_ms, 1e-9)
            out["irregular_spmv_path"] = label
            out["autotune_verdicts"] = moved("autotune.verdict.records")
            if sp is not None:
                sp.set(n=n, nnz=A.nnz, path=label,
                       speedup=out["irregular_spmv_speedup"])
        finally:
            settings.autotune = saved
            autotune.reset()
    return out


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="every phase at tiny sizes (SMOKE)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without one)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the bench; prints its JSON line and returns it as a dict."""
    import torch

    args = _parse(argv)
    t_start = time.perf_counter()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import linalg, obs, runtime
    from legate_sparse_tpu_torch.apps.common import TorchTimer
    from legate_sparse_tpu_torch.bench_timing import (loop_ms_per_iter,
                                                      time_ms, triad_gbs)
    from legate_sparse_tpu_torch.obs import trace as obs_trace
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    runtime.set_device(dev)
    smoke = args.smoke
    if smoke and dev.type == "cpu":
        # One thread: on a shared host the tiny loops' timings then
        # resolve; the CPU lane measures no device metric.
        torch.set_num_threads(1)
    size = SMOKE if smoke else FULL
    cuda = dev.type == "cuda"
    obs_requested = obs.enabled()

    result = {"metric": "csr_spmv_bandwidth", "value": None, "unit": "GB/s",
              "vs_baseline": None, "platform": dev.type,
              "schema_version": SCHEMA_VERSION}
    if cuda:
        result["device_name"] = torch.cuda.get_device_name(dev)
        result["nvidia_smi"] = _smi_line()
    if smoke:
        result["smoke"] = True

    phase_s = result.setdefault("phase_s", {})
    phase, phase_t0 = "spmv", time.perf_counter()

    def end_phase() -> None:
        """Charge the seconds since the current phase began to it."""
        phase_s[phase] = time.perf_counter() - phase_t0

    def start_phase(name: str) -> None:
        nonlocal phase, phase_t0
        end_phase()
        phase, phase_t0 = name, time.perf_counter()

    def timed_ms(fn) -> float:
        return time_ms(fn, device=dev)

    n = 1 << size["log2_rows"]
    lanes = size["stream_lanes"]
    stream_samples = []

    def sample_stream(k: int) -> float:
        for _ in range(k):
            stream_samples.append(triad_gbs(log2_lanes=lanes, device=dev))
        med = statistics.median(stream_samples)
        result["stream_samples"] = stream_samples
        result["stream_gbs_min"] = min(stream_samples)
        result["stream_gbs_median"] = med
        result["stream_gbs_max"] = max(stream_samples)
        result["stream_gbs"] = med
        return med

    # ---- stream before, SpMV, stream after -------------------------------
    sample_stream(2)
    with obs.span("bench.spmv") as sp, obs.memory.watermark("bench.spmv"):
        A = _banded_config(sparse, n, NNZ_PER_ROW, device=dev)
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        spmv_bytes = _spmv_bytes(A, x)
        spmv_ms = timed_ms(lambda: A @ x)
        if sp is not None:
            sp.set(nnz=A.nnz, bytes=spmv_bytes, rows=n, spmv_ms=spmv_ms)
    stream = sample_stream(3)
    bw = spmv_bytes / (spmv_ms * 1e-3) / 1e9
    result["value"] = bw
    result["spmv_ms"] = spmv_ms
    result["spmv_rows"] = n
    result["path"] = ("dia" if A._get_dia() is not None
                      else "ell" if A._get_ell() is not None else "csr")
    result["spmv_path"] = A.spmv_path
    result["spmv_bytes"] = spmv_bytes
    result["spmv_bytes_per_nnz"] = round(spmv_bytes / A.nnz, 4)
    C_s = A.compress()
    result["spmv_bytes_per_nnz_bf16"] = round(_spmv_bytes(C_s, x) / C_s.nnz,
                                              4)
    del C_s
    if cuda:
        result["vs_baseline"] = bw / stream
    else:
        result["cpu_vs_baseline"] = bw / stream

    # ---- obs overhead: the same SpMV loop with a span a step, on vs off --
    def probe_step(v):
        with obs.span("bench.obs_probe"):
            return A @ v

    was_on = obs.enabled()
    try:
        obs.enable()
        ms_on = loop_ms_per_iter(probe_step, x, k_lo=3, k_hi=15)
        obs.disable()
        ms_off = loop_ms_per_iter(probe_step, x, k_lo=3, k_hi=15)
    finally:
        (obs.enable if was_on else obs.disable)()
    result["obs_overhead_pct"] = max(0.0, (ms_on - ms_off) / ms_off * 100.0)
    del A, x

    # ---- CG on the 1024^2 Poisson grid ------------------------------------
    start_phase("cg")
    grid = size["cg_grid"]
    A_cg = _poisson_f32(grid, dev)
    b = torch.ones(grid * grid, dtype=torch.float32, device=dev)
    with obs.span("bench.cg") as sp:
        cg = _delta_ms_per_iter(
            dev, lambda k: linalg.cg(A_cg, b, rtol=0.0, maxiter=k), 100, 300)
        if sp is not None:
            sp.set(nnz=A_cg.nnz, rows=grid * grid,
                   bytes=_spmv_bytes(A_cg, b), ms_per_iter=cg["median"])
    result["cg_grid"] = f"{grid}x{grid}"
    result["cg_ms_per_iter"] = cg["median"]
    result["cg_ms_per_iter_min"] = cg["min"]
    result["cg_ms_per_iter_max"] = cg["max"]
    del A_cg, b

    # ---- irregular SpMV ------------------------------------------------
    start_phase("irregular")
    rows_ir = size["irregular_rows"]
    A_ir = _irregular_config(sparse, rows_ir, NNZ_PER_ROW, device=dev)
    x_ir = torch.ones((rows_ir,), dtype=torch.float32, device=dev)

    def normalised(v):
        y = A_ir @ v
        return y * torch.rsqrt(torch.mean(y * y) + 1e-20)

    ms_ir = loop_ms_per_iter(normalised, x_ir, k_lo=2, k_hi=12)
    by_ir = _spmv_bytes(A_ir, x_ir) + 2 * 4 * rows_ir  # + normalise
    result["irregular_rows"] = rows_ir
    result["irregular_path"] = A_ir.spmv_path
    result["irregular_ms"] = ms_ir
    result["irregular_gbs"] = by_ir / (ms_ir * 1e-3) / 1e9
    result["irregular_frac"] = result["irregular_gbs"] / stream
    del A_ir, x_ir

    # ---- BSR through the block kernel -------------------------------------
    start_phase("bsr")
    nb_n = size["bsr_rows"]
    A_b, st = _bsr_config(sparse, nb_n, dev)
    xb = torch.ones((nb_n,), dtype=torch.float32, device=dev)
    ms = timed_ms(lambda: st.matvec(xb))
    result["bsr_rows"] = nb_n
    result["bsr_ms"] = ms
    result["bsr_gbs"] = A_b.nnz * 8 / (ms * 1e-3) / 1e9
    result["bsr_stream_gbs"] = st.nblocks * 128 * 128 * 4 / (ms * 1e-3) / 1e9
    del A_b, st, xb

    # ---- banded SpGEMM, beside host scipy ---------------------------------
    start_phase("spgemm")
    n_gm = size["spgemm_rows"]
    timer = TorchTimer(dev)
    with obs.span("bench.spgemm") as sp, obs.memory.watermark("bench.spgemm"):
        A_gm = _banded_config(sparse, n_gm, NNZ_PER_ROW, device=dev)
        C = A_gm @ A_gm
        times = []
        for _ in range(SOLVE_SAMPLES):
            timer.start()
            A_gm @ A_gm
            times.append(timer.stop())
        if sp is not None:
            sp.set(n=n_gm, nnz=C.nnz,
                   bytes=(2 * A_gm.nnz + C.nnz) * C.data.element_size(),
                   spgemm_ms=statistics.median(times))
    A_host = A_gm.toscipy()
    host = []
    for _ in range(SOLVE_SAMPLES):
        t0 = time.perf_counter()
        A_host @ A_host
        host.append((time.perf_counter() - t0) * 1e3)
    result["spgemm_n"] = n_gm
    result["spgemm_path"] = A_gm.spgemm_path
    result["spgemm_ms"] = statistics.median(times)
    result["spgemm_ms_min"], result["spgemm_ms_max"] = min(times), max(times)
    result["spgemm_scipy_ms"] = statistics.median(host)
    result["spgemm_vs_scipy"] = (result["spgemm_scipy_ms"]
                                 / result["spgemm_ms"])
    del A_gm, C, A_host

    # ---- GMG-preconditioned CG on one rank --------------------------------
    start_phase("gmg")
    grid = size["gmg_grid"]
    rec = run_ranks(_gmg_rank, 1, backend="nccl" if cuda else "gloo",
                    timeout=600, args=(grid, 3))[0]
    result["gmg_grid"] = f"{grid}x{grid}"
    result["gmg_cycle_ms"] = rec["cycle_ms"]
    result["gmg_cg_ms_per_iter"] = rec["cg"]["median"]
    result["gmg_cg_ms_per_iter_min"] = rec["cg"]["min"]
    result["gmg_cg_ms_per_iter_max"] = rec["cg"]["max"]
    result["gmg_build_s"] = rec["build_s"]
    rank_launches = {"gmg": rec["launches"]}

    # ---- scale anchors: CG at 1e6 rows, the pde_4096 explicit update ------
    start_phase("cg_1m")
    grid = size["cg_1m_grid"]
    A_1m = _poisson_f32(grid, dev)
    b = torch.ones(grid * grid, dtype=torch.float32, device=dev)
    cg = _delta_ms_per_iter(
        dev, lambda k: linalg.cg(A_1m, b, rtol=0.0, maxiter=k), 50, 150)
    result["cg_1m_rows"] = grid * grid
    result["cg_1m_ms_per_iter"] = cg["median"]
    result["cg_1m_ms_per_iter_min"] = cg["min"]
    result["cg_1m_ms_per_iter_max"] = cg["max"]
    del A_1m, b

    start_phase("pde_4096")
    grid = size["pde_grid"]
    ng = grid * grid
    A_p = _poisson_f32(grid, dev)
    x_p = torch.ones((ng,), dtype=torch.float32, device=dev)
    b_p = torch.full((ng,), 1e-6, dtype=torch.float32, device=dev)
    # rho(I - 0.25 A) <= 1 (spec(A) in [0, 8]): the chain is stable.
    ms_p = loop_ms_per_iter(lambda v: v - 0.25 * (A_p @ v) + b_p, x_p,
                            k_lo=2, k_hi=8)
    by_p = _spmv_bytes(A_p, x_p) + 4 * ng       # + the b read
    result["pde_grid"] = f"{grid}x{grid}"
    result["pde_path"] = A_p.spmv_path
    result["pde_ms_per_iter"] = ms_p
    result["pde_bytes_per_iter"] = by_p
    C_p = A_p.compress()
    vb, bb = x_p.to(torch.bfloat16), b_p.to(torch.bfloat16)
    ms_pb = loop_ms_per_iter(lambda v: v - 0.25 * (C_p @ v) + bb, vb,
                             k_lo=2, k_hi=8)
    by_pb = _spmv_bytes(C_p, vb) + 2 * ng
    result["pde_ms_per_iter_bf16"] = ms_pb
    result["pde_bytes_per_iter_bf16"] = by_pb
    result["pde_bytes_ratio"] = by_p / by_pb
    bound_p = by_p / (stream * 1e9) * 1e3
    result["pde_stream_bound_ms"] = bound_p
    result["pde_roofline_ratio"] = bound_p / ms_p
    del A_p, x_p, b_p, C_p, vb, bb

    # ---- bf16 banded SpMV ----------------------------------------------
    start_phase("bf16")
    A16 = _banded_config(sparse, n, NNZ_PER_ROW, dtype=torch.bfloat16,
                         device=dev)
    x16 = torch.ones((n,), dtype=torch.bfloat16, device=dev)
    by16 = _spmv_bytes(A16, x16)
    ms16 = timed_ms(lambda: A16 @ x16)
    result["bf16_path"] = A16.spmv_path
    result["bf16_ms"] = ms16
    result["bf16_gbs"] = by16 / (ms16 * 1e-3) / 1e9
    del A16, x16

    # ---- the distributed phases: one launch of the job's ranks ------------
    start_phase("ranks")
    if smoke:
        world, backend = SMOKE_RANKS, "gloo"
    elif cuda:
        world, backend = torch.cuda.device_count(), "nccl"
        torch.cuda.empty_cache()
    else:
        world, backend = 1, "gloo"
    rec = run_ranks(_rank_phases, world, backend=backend, timeout=1800,
                    threads=1 if backend == "gloo" else None,
                    args=(size, obs.enabled()))[0]
    fields = rec["fields"]
    attrib_wire_ms = fields.pop("attrib_wire_ms")
    result.update(fields)
    result["rank_phase_s"] = rec["phase_s"]
    result["rank_kernel_launches"] = {**rank_launches, **rec["launches"]}
    for r in rec["spans"]:
        obs_trace.complete_span(r["name"], r["ts_ns"], r["dur_ns"],
                                **dict(r.get("attrs") or {}, rank=0))
    rank_comm = rec["comm_counters"]

    # ---- the serving phases, in this process -------------------------------
    for name, run_phase in (("engine", _engine_phase),
                            ("resil", _resil_phase),
                            ("saturation", _saturation_phase),
                            ("gateway", _gateway_phase),
                            ("attrib", _attrib_load_phase),
                            ("mutation", _mutation_phase)):
        start_phase(name)
        result.update(run_phase(sparse, size, dev))
    result["attrib_ms"] = result.pop("attrib_load_ms") + attrib_wire_ms
    start_phase("autotune")
    result.update(_autotune_phase(sparse, size, dev, smoke))

    end_phase()
    mem = obs.memory.snapshot()
    result["mem_peak_rss_mb"] = mem.get("peak_rss_mb")
    result["mem_device_peak_mb"] = mem.get("device_peak_mb")
    result["bench_wall_s"] = time.perf_counter() - t_start

    if obs_requested or obs.enabled():
        trace_path = os.environ.get("LEGATE_SPARSE_TPU_OBS_FILE")
        if not trace_path:
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            trace_path = f"BENCH_{stamp}.trace.json"
        n_spans = sum(1 for r in obs.records() if r["type"] == "span")
        # The trace's counters: this process's, plus rank 0's comm
        # ledger (the distributed phases' collectives ran there).
        counters = obs.counters.snapshot()
        for k, v in rank_comm.items():
            counters[k] = counters.get(k, 0) + v
        obs.write_chrome_trace(trace_path, extra_metadata={
            "platform": dev.type, "bench_result": result,
            "counters": counters})
        result["trace_file"] = trace_path
        result["trace_spans"] = n_spans
        print(json.dumps(result), flush=True)
        if n_spans == 0:
            raise RuntimeError(f"bench_torch: tracing was asked for but no "
                               f"span was recorded ({trace_path})")
        return result
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
