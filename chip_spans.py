#!/usr/bin/env python3
# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The spanned slice of a ``spbench`` cell on one CUDA card: the port's
spans joined to the device's trace (``obs.timeline``), beside the
cell's own profiled slice.

    python3 chip_spans.py --workload <name> --seed <n> [--repeat <k>]

From the root of a checkout.  It sets up the cell as
``spbench/run.py --trace 1`` does (``spbench.core.harness.build``), with
the port's tracing on around the set-up alone, so the GMG hierarchy's
laps are ``gmg.build.*`` spans.  It runs the cell's units for a few
seconds, then ``--repeat`` times: the cell's profiled slice
(``Mix.profiled``: ``torch.profiler`` over ``profile.solves`` solves or
``profile.seconds`` of products, and in the GMG cell the V-cycle timed
by CUDA events over as many solves after it), then the spanned slice:
the same units under ``obs.timeline.Slice`` (the same device-only
profiler, tracing on, anchors at both ends).

Prints the card's ``nvidia-smi`` name and power limit on standard error
and one JSON line on standard output:

- ``setup``: the set-up's seconds (``setup_s``, ``operator_s``,
  ``hierarchy_s``) and the sums of the ``gmg.build.*`` spans;
- ``slices``: for each repeat, the profiled slice's wall time a unit,
  busy share and idle gaps by runtime call (``breakdown``), the spanned
  slice's wall time a unit, busy share, kernel launches and those
  whose device record the trace lacks (``lost``), ``device_by_span`` and
  ``idle_gaps_by_span`` (top 10, seconds), the clock offset's bound and
  skew (us), and the span counts;
- ``metrics``: per repeat, ``cg.vector_ms_per_iter`` (device ms of the
  kernels launched in ``cg.iter`` outside ``spmv``, ``spmm`` and
  ``gmg.cycle``, over the ``cg.iter`` spans), ``cg.host_syncs``
  (``transfer.host_sync.cg_conv`` over the slice, over its solves),
  ``gmg.vcycle.fine_ms`` and ``.coarse_ms`` (device ms launched in
  level 0's ``gmg.level`` and not deeper, and in levels 1 and below,
  over the ``gmg.cycle`` spans), ``gmg.vcycle_ms`` (the CUDA events'),
  ``dispatch.spmv_host_us`` (the ``lat.spmv.<bucket>`` histogram over
  the slice, its sum over its count), ``dispatch.spmv_span_us`` and
  ``dispatch.spmv_own_us`` (the ``spmv`` spans' mean length, and the
  same less the runtime calls inside them), and the set-up's
  ``gmg.hierarchy.{restriction,galerkin,smoother}_s``.

Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
os.environ["LEGATE_SPARSE_TPU_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "build", "torch_kernels")

import torch  # noqa: E402

torch.set_num_threads(1)

from spbench.core import harness, spec  # noqa: E402
from spbench.core.traffic import Window  # noqa: E402

PRECONDITIONER_SPANS = ("spmv", "spmm", "gmg.cycle")
BUILD_PARTS = ("restriction", "galerkin", "smoother")


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _units(mix, w: Window, kind: str) -> None:
    """The profiled slice's units, each one ``Mix.step``: its solves or
    its seconds of products."""
    if kind == "solve":
        for _ in range(int(mix.mix["profile"]["solves"])):
            mix.step(w)
        return
    t1 = time.perf_counter()
    while True:
        mix.step(w)
        if time.perf_counter() - t1 >= float(mix.mix["profile"]["seconds"]):
            break


def _metrics(tl, kind: str, solves: int, rows: int) -> dict:
    from legate_sparse_tpu_torch.obs.latency import shape_bucket

    out = {}
    iters = tl.count("cg.iter")
    if iters:
        out["cg.vector_ms_per_iter"] = tl.device_seconds(
            "cg.iter", PRECONDITIONER_SPANS) * 1e3 / iters
    if kind == "solve" and solves:
        out["cg.host_syncs"] = tl.counters.get(
            "transfer.host_sync.cg_conv", 0) / solves
        out["cg.fetch_spans_per_solve"] = tl.count("cg.fetch") / solves
    cycles = tl.count("gmg.cycle")
    if cycles:
        by = tl.device_seconds_by("gmg.level", "level")
        out["gmg.vcycle.fine_ms"] = by.get(0, 0.0) * 1e3 / cycles
        out["gmg.vcycle.coarse_ms"] = sum(
            v for k, v in by.items() if k != 0) * 1e3 / cycles
        out["gmg.vcycle.by_level_ms"] = {
            str(k): v * 1e3 / cycles for k, v in sorted(by.items())}
    hist = tl.histograms.get("lat.spmv." + shape_bucket(rows))
    if hist and hist[0]:
        out["dispatch.spmv_host_us"] = hist[1] * 1e3 / hist[0]
        out["dispatch.spmv_calls"] = hist[0]
    n = tl.count("spmv")
    if n:
        out["dispatch.spmv_span_us"] = tl.span_seconds("spmv") * 1e6 / n
        out["dispatch.spmv_own_us"] = tl.host_seconds("spmv") * 1e6 / n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--warm-seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_spans: no CUDA device", file=sys.stderr)
        return 2
    out = measure(spec.cell(args.workload), torch.device("cuda", 0),
                  args.seed, args.repeat, args.warm_seconds)
    print(f"chip_spans: card {out['card']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def measure(cell, dev, seed: int, repeat: int, warm_seconds: float) -> dict:
    """The set-up, then ``repeat`` pairs of slices: the result line."""
    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.obs import timeline

    kind = cell.traffic["kind"]
    obs.reset_all()
    obs.enable()
    A, M, mix, setup = harness.build(cell, dev, seed, True, T_START)
    obs.disable()
    build = {part: sum(r["dur_ns"] for r in obs.records()
                       if r["name"] == "gmg.build." + part) * 1e-9
             for part in BUILD_PARTS}
    out = {"workload": cell.name, "seed": seed, "card": _smi(),
           "setup": dict(setup, build_spans_s=build), "slices": [],
           "metrics": []}
    # Bound as ``Mix.run`` binds them before its window.
    mix.A, mix.M = A, M
    w = Window()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_seconds:
        mix.step(w)
    for _ in range(repeat):
        c0, i0 = w.count, w.slice_iters
        mix.profiled(w)
        t = w.trace
        # The solve kind runs as many solves again after its slice to
        # time the V-cycle by CUDA events.
        n_prof = (int(mix.mix["profile"]["solves"]) if kind == "solve"
                  else w.count - c0)
        c1 = w.count
        with timeline.Slice(dev) as sl:
            _units(mix, w, kind)
        tl = sl.timeline
        n_span = w.count - c1
        rec = {
            "profiled": {
                "units": n_prof, "wall_s": t.window_s,
                "ms_per_unit": t.window_s * 1e3 / n_prof,
                "busy": t.busy_s / t.window_s,
                "launches": t.launches,
                "iters": w.slice_iters - i0,
                "breakdown": t.breakdown()},
            "spanned": {
                "units": n_span, "wall_s": sl.wall_s,
                "ms_per_unit": sl.wall_s * 1e3 / n_span,
                "busy": tl.busy_s() / sl.wall_s,
                "ops": len(tl.ops),
                "launches": tl.launches,
                "lost": tl.lost,
                "device_by_span": tl.device_by_span(),
                "idle_gaps_by_span": tl.idle_by_span(),
                "offset_bound_us": tl.offset_bound_us,
                "skew_us": tl.skew_us,
                "spans": {name: tl.count(name) for name in (
                    "cg", "cg.iter", "cg.fetch", "gmg.cycle", "gmg.level",
                    "spmv", "obs.anchor")}},
        }
        m = _metrics(tl, kind, n_span, mix.n)
        if w.vcycle_s:
            m["gmg.vcycle_ms"] = sum(w.vcycle_s) * 1e3 / len(w.vcycle_s)
        if "hierarchy_s" in setup:
            for part in BUILD_PARTS:
                m[f"gmg.hierarchy.{part}_s"] = build[part]
        out["slices"].append(rec)
        out["metrics"].append(m)
        w.vcycle_s = []
    return out


if __name__ == "__main__":
    raise SystemExit(main())
