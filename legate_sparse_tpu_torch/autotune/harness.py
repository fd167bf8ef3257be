# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Measurement harness: race the eligible candidates, record a verdict
(the port of ``legate_sparse_tpu/autotune/harness.py``).

Warmup calls absorb first-touch costs; each trial is timed on the host
clock between two ``torch.cuda.synchronize()`` calls on the card (the
JAX package's ``block_until_ready``), on the host clock alone on the
CPU; the figure is the median of k trials.  A verdict compares
candidates against each other on one matrix, so the fixed per-call cost
biases every candidate equally.

The trial and warmup budget comes from ``settings.autotune_trials`` /
``settings.autotune_warmup`` unless a call overrides it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from .. import obs as _obs
from ..settings import settings as _settings
from .registry import CANDIDATES
from .store import key_for


def time_kernel(fn, warmup: Optional[int] = None,
                trials: Optional[int] = None, device=None) -> float:
    """Median-of-k wall ms of ``fn()`` (a zero-argument dispatch) after
    ``warmup`` unmeasured calls; each trial ends on a synchronize of
    ``device`` when it is a CUDA device."""
    warmup = _settings.autotune_warmup if warmup is None else warmup
    trials = _settings.autotune_trials if trials is None else trials
    cuda = device is not None and torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(max(int(warmup), 1)):
        fn()
    samples = []
    for _ in range(max(int(trials), 1)):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    _obs.inc("autotune.measure.trials", len(samples))
    samples.sort()
    return samples[len(samples) // 2]


def eligible_candidates(A, op: str = "spmv") -> dict:
    """{label: Candidate} of the registry entries that can serve ``op``
    on this matrix (builds the lazy caches the dispatch would)."""
    return {label: cand for label, cand in CANDIDATES.items()
            if op in cand.ops and cand.eligible(A)}


def measure_candidates(A, x=None, op: str = "spmv",
                       warmup: Optional[int] = None,
                       trials: Optional[int] = None
                       ) -> Dict[str, float]:
    """Time every eligible candidate for ``op`` on ``A``: {label: median
    ms}.  ``x`` defaults to ones of the matrix dtype (4 columns for
    spmm)."""
    if x is None:
        shape = (A.shape[1],) if op == "spmv" else (A.shape[1], 4)
        x = torch.ones(shape, dtype=A.dtype, device=A.device)
    timings: Dict[str, float] = {}
    for label, cand in eligible_candidates(A, op).items():
        timings[label] = time_kernel(
            lambda c=cand: c.run(A, x, op), warmup=warmup, trials=trials,
            device=A.device)
    return timings


def tune(A, x=None, op: str = "spmv", store=None,
         warmup: Optional[int] = None, trials: Optional[int] = None):
    """Race the candidates and record the winner into ``store`` (the
    process store by default).  Returns the recorded
    :class:`~.store.Verdict`, or None when no candidate is eligible."""
    timings = measure_candidates(A, x=x, op=op, warmup=warmup,
                                 trials=trials)
    if not timings:
        return None
    k = 1
    if op == "spmm" and x is not None and x.dim() == 2:
        k = int(x.shape[1])
    key = key_for(A, op, k=k)
    if store is None:
        from . import get_store

        store = get_store()
    label = min(timings, key=timings.get)
    trials_used = (_settings.autotune_trials if trials is None
                   else int(trials))
    return store.record(key, label, timings_ms=timings,
                        trials=trials_used)
