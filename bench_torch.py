#!/usr/bin/env python3
# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Headline bench of the PyTorch port: banded SpMV bandwidth on one card.

The port of ``bench.py``'s headline phases, at its configurations and
sizes, under its JSON field names.  Run it from the root of a checkout::

    python bench_torch.py                      # on cuda; raises without one
    python bench_torch.py --smoke --device cpu # every phase, tiny, seconds

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
- ``mem_peak_rss_mb``, ``mem_device_peak_mb`` (null on the CPU) and
  ``bench_wall_s``.

Ratios against the stream median (``vs_baseline``, ``irregular_frac``)
name the card's achievable bandwidth as measured in the same run; on the
CPU ``vs_baseline`` is null and the ratio is ``cpu_vs_baseline``.  The
record also names the card and its power limit (``device_name``,
``nvidia_smi``: ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``).

The sizes are ``FULL`` on any device; ``--smoke`` runs every phase at
tiny sizes (``SMOKE``), on the CPU with one thread.  With
``LEGATE_SPARSE_TPU_OBS=1`` the run also writes
``BENCH_<stamp>.trace.json`` (``LEGATE_SPARSE_TPU_OBS_FILE`` overrides
the path) and exits non-zero if it holds no span.
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
        "pde_grid": 4096}
SMOKE = {"log2_rows": 12, "stream_lanes": 20, "cg_grid": 32,
         "irregular_rows": 1 << 12, "bsr_rows": 1 << 10,
         "spgemm_rows": 1 << 12, "gmg_grid": 32, "cg_1m_grid": 32,
         "pde_grid": 64}
BSR_DENSITY = 0.05
NNZ_PER_ROW = 11
SOLVE_SAMPLES = 5
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
            "cycle_comm_bytes": gmg.cycle_comm_bytes}


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
              "vs_baseline": None, "platform": dev.type}
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
        obs.write_chrome_trace(trace_path, extra_metadata={
            "platform": dev.type, "bench_result": result})
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
