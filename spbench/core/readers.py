"""Readings that several metrics share; each metric's file chooses the
traffic kind (and the kernel) it reads, and ``BENCHMARK.json`` the
cells that report it."""

from __future__ import annotations

from typing import Optional

from . import work


def idle_pct(ctx, kind: str) -> Optional[float]:
    """The share of the profiled slice's wall time in which no kernel,
    copy or set ran on the device, from the profiler's timeline, in
    cells of the traffic ``kind``."""
    t = ctx.trace
    if ctx.kind != kind or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def spmv_roofline(ctx, kind: str, kernel: str) -> Optional[float]:
    """The least time of one product of the configuration's operator
    (``work.py``: its stored values, x and y once each, over the data
    sheet's bandwidth) over the mean device time of the kernels whose
    name holds ``kernel`` in the profiled slice, in cells of the
    traffic ``kind``.  It holds only where every such launch is a
    product of that operator: the metric's ``workloads`` say where."""
    t = ctx.trace
    if ctx.kind != kind or t is None:
        return None
    n, seconds = t.matching(kernel)
    if not n or seconds <= 0:
        return None
    return 100.0 * work.spmv_min_seconds(ctx.config) / (seconds / n)


def ms_per_unit(ctx, kind: str) -> Optional[float]:
    """The window's wall time over the units it completed (solves,
    products), in cells of the traffic ``kind``."""
    if ctx.kind != kind or not ctx.window.count:
        return None
    return ctx.window.wall_s * 1e3 / ctx.window.count


def mean_iters(ctx) -> Optional[float]:
    """The iterations the solver returned, summed over the window's
    solves, over the solves."""
    iters = ctx.window.iters
    if ctx.kind != "solve" or not iters:
        return None
    return sum(iters) / len(iters)


def launches_per_iter(ctx) -> Optional[float]:
    """Device kernel launches in the profiled slice (copies and sets
    left out) over the solver iterations of its solves."""
    t = ctx.trace
    if ctx.kind != "solve" or t is None or not ctx.window.slice_iters:
        return None
    return t.launches / ctx.window.slice_iters
