# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Device timing for the port's benches and checks.

The port of ``legate_sparse_tpu/bench_timing.py`` under its names, plus
``time_ms``, the kernel timer of ``chip_smoke.py``.

Two methods, for two kinds of work:

- ``time_ms`` times a kernel: CUDA events around ``INNER`` calls in a
  row (the card runs them back to back, so the host's cost of each
  launch stays out), the median of ``reps`` such samples after 3
  warm-ups.
- ``loop_ms_per_iter`` times a loop the way a user runs it: ``step``
  chained ``k`` times, each application consuming the previous result,
  at two trip counts; the time difference over the trip-count
  difference cancels the fixed costs (the first launch, the fence).
  Run eagerly, each iteration also pays its launches' host cost, which
  a user's loop pays too.

On ``cuda`` the fence is ``torch.cuda.synchronize()`` (and the kernel
timer CUDA events); on the CPU, where every op has finished when it
returns, the clock is ``time.perf_counter`` alone.  Nothing here
imports more than torch and numpy.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

REPS = 25
INNER = 10                     # calls per timed sample
# The card's peaks that a bound is priced at: the least time of a
# function is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside tensor cores


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _fence(device) -> None:
    if _is_cuda(device):
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int = REPS, device="cuda") -> float:
    """Median over ``reps`` samples of the time per call of ``INNER``
    calls in a row: the card runs them back to back, so the host's
    cost of each launch stays out of a kernel's time.  On the CPU the
    samples are host-clock times of the same calls."""
    for _ in range(3):
        fn()
    _fence(device)
    times = []
    for _ in range(reps):
        if _is_cuda(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(INNER):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / INNER)
        else:
            t0 = time.perf_counter()
            for _ in range(INNER):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / INNER)
    return float(np.median(times))


def triad_gbs(log2_lanes: int = 26, k_lo: int = 3, k_hi: int = 18,
              device="cuda") -> float:
    """One measured STREAM-triad bandwidth sample (GB/s): ``x' = a*x +
    y`` over ``2**log2_lanes`` f32 lanes (the default 2^26 = 256 MB a
    vector, 768 MB moved an iteration, well past the 50 MB L2), priced
    at 3 x 4 x n bytes.  One fused kernel an iteration
    (``torch.add(y, x, alpha=a)``: read x and y, write x').  Callers
    that want a denominator take several samples around their phases
    and use the median."""
    n = 1 << log2_lanes
    dev = torch.device(device)
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    y = torch.full((n,), 1e-9, dtype=torch.float32, device=dev)
    ms = loop_ms_per_iter(lambda v: torch.add(y, v, alpha=1.0000001), x,
                          k_lo=k_lo, k_hi=k_hi)
    return 3 * 4 * n / (ms * 1e-3) / 1e9


def fixed_cost_s(x0: torch.Tensor, repeats: int = 3) -> float:
    """Measured fixed cost of one tiny op on ``x0``'s device and its
    fence (the constant both ends of the two-point measurement share):
    microseconds on the CPU, a launch and a synchronise on the card."""
    def probe():
        v = x0.reshape(-1)[:1] * 1.0
        _fence(x0.device)
        return v

    probe()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        probe()
        best = min(best, time.perf_counter() - t0)
    return best


def loop_ms_per_iter(step: Callable, x0: torch.Tensor, k_lo: int = 5,
                     k_hi: Optional[int] = None, repeats: int = 2,
                     deadline_s: Optional[float] = None,
                     k_cap: int = 4000,
                     agree: Optional[Callable[[float], float]] = None
                     ) -> float:
    """Milliseconds per ``step`` application in a chained loop (see the
    module docstring).

    ``step``: x -> x on ``x0``'s device, magnitude-preserving so
    hundreds of chained applications neither overflow nor denormalise.
    ``k_hi`` is the first high trip count (None picks it from the
    fixed-cost estimate); ``k_cap`` bounds every trip count;
    ``deadline_s`` (wall clock for this call) stops escalation early.
    Beyond the first pair, the trip counts are aimed from the measured
    points.  A high trip count not measurably slower than the low one
    raises ``RuntimeError("unresolvable timing ...")``: the result is
    positive and never clamped.

    ``agree`` turns each measured time (seconds) into the job's: every
    rank of a job whose ``step`` runs collectives passes the same
    function (the slowest rank's time, by an all-reduce), so every rank
    takes the same trip counts and its collectives stay matched; such
    callers pass no ``deadline_s``, which reads each rank's own clock."""
    if agree is None:
        def agree(t: float) -> float:
            return t
    device = x0.device
    t_start = time.perf_counter()

    def run(k: int) -> None:
        v = x0
        for _ in range(k):
            v = step(v)
        _fence(device)

    def timed(k: int) -> float:
        run(k)  # warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(k)
            best = min(best, time.perf_counter() - t0)
        return agree(best)

    def left() -> float:
        if deadline_s is None:
            return float("inf")
        return deadline_s - (time.perf_counter() - t_start)

    fixed = agree(fixed_cost_s(x0))
    t_lo = timed(k_lo)
    # Delta target sized so the loop-body difference dominates
    # fixed-cost jitter; per-iter upper bound from the low point alone.
    per_iter_est = max(t_lo - fixed, 0.25 * t_lo) / k_lo
    delta_target = max(4.0 * fixed, 0.4, 0.5 * t_lo)
    if k_hi is None:
        k_hi = k_lo + int(delta_target / max(per_iter_est, 1e-9)) + 1
    k_hi = min(k_cap, max(3 * k_lo, k_hi))
    while True:
        t_hi = timed(k_hi)
        # Strictly above the floor: equal times (a clock that did not
        # move) resolve nothing.
        good = t_hi - t_lo > max(2.0 * fixed, 0.2 * t_lo)
        if good or k_hi >= k_cap:
            break
        if left() < 3 * t_hi + 30:
            # No wall budget for another run: use what we have if it
            # resolves at all, else fail loudly.
            break
        # Re-aim from the measured points (one jump, not x4 blind).
        per_iter = ((t_hi - t_lo) / (k_hi - k_lo)
                    if t_hi > t_lo else per_iter_est / 8)
        k_next = k_lo + int(delta_target / max(per_iter, 1e-9)) + 1
        k_hi = min(k_cap, max(k_next, 2 * k_hi))
    if not good:
        raise RuntimeError(
            f"unresolvable timing: {k_hi} iters ({t_hi:.4f}s) not "
            f"measurably slower than {k_lo} ({t_lo:.4f}s; "
            f"noise floor {max(2.0 * fixed, 0.2 * t_lo):.4f}s)"
        )
    return (t_hi - t_lo) / (k_hi - k_lo) * 1e3
