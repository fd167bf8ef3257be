# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Sparsity fingerprints: cheap, deterministic structure descriptors
(the port of ``legate_sparse_tpu/autotune/fingerprint.py``).

A handful of O(rows) and O(nnz) reductions, computed once per matrix
(cached on ``csr_array`` beside its structure caches) and discretized
into a class label that verdict keys carry:

- ``row_mean`` / ``row_cv`` / ``row_max_ratio`` — row-length moments:
  mean stored entries per row, coefficient of variation (the skew
  signal) and max/mean (flat ELL's padding factor), in f64 on the host
  from ``indptr``, as the JAX package computes them;
- ``spread`` — bandedness: mean ``|col - row|`` over cols;
- ``block_score`` — fraction of adjacent stored entries sharing an
  8-wide column block;
- ``width_bucket`` — power-of-two bucket of the mean row length.

``spread`` and ``block_score`` are f32 means on the matrix's device;
torch sums them in another order than XLA, so they agree with the JAX
package's to about 1e-6 relative, and the class label is the same.
The label (``Fingerprint.klass``) is ``<kind>/w<width_bucket>`` with
kind one of ``banded`` / ``blocky`` / ``uniform`` / ``skewed`` /
``powerlaw`` / ``empty``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.buckets import next_pow2


@dataclass(frozen=True)
class Fingerprint:
    """Structure descriptor of one CSR matrix (host scalars only)."""

    rows: int
    cols: int
    nnz: int
    row_mean: float
    row_cv: float
    row_max_ratio: float
    spread: float
    block_score: float
    width_bucket: int

    @property
    def klass(self) -> str:
        """Coarse class label, the verdict-key term.  The thresholds
        are wide on purpose: a verdict should cover every matrix the
        same kernel ranking plausibly applies to."""
        if self.nnz == 0:
            return "empty/w1"
        if self.spread < 0.02 and self.row_cv < 0.5:
            kind = "banded"
        elif self.block_score >= 0.6:
            kind = "blocky"
        elif self.row_cv < 0.25:
            kind = "uniform"
        elif self.row_cv < 1.0:
            kind = "skewed"
        else:
            kind = "powerlaw"
        return f"{kind}/w{self.width_bucket}"


def compute_fingerprint(A) -> Fingerprint:
    """Fingerprint of a ``csr_array``: one (rows+1,) host transfer and
    two device reductions, each read back once."""
    rows, cols = A.shape
    nnz = A.nnz
    if nnz == 0 or rows == 0:
        return Fingerprint(rows, cols, nnz, 0.0, 0.0, 0.0, 0.0, 0.0, 1)
    indptr = A.indptr.cpu().numpy()
    counts = (indptr[1:] - indptr[:-1]).astype(np.float64)
    mean = float(counts.mean())
    cv = float(counts.std() / mean) if mean > 0 else 0.0
    mx = float(counts.max() / mean) if mean > 0 else 0.0
    indices = A.indices
    spread = float(torch.mean(torch.abs(
        indices.to(torch.float32) - A._get_row_ids().to(torch.float32)
    ))) / max(cols, 1)
    if nnz >= 2:
        block_score = float(torch.mean(
            (indices[1:] // 8 == indices[:-1] // 8).to(torch.float32)))
    else:
        block_score = 1.0
    return Fingerprint(
        rows=rows, cols=cols, nnz=nnz,
        row_mean=round(mean, 6), row_cv=round(cv, 6),
        row_max_ratio=round(mx, 6), spread=round(spread, 6),
        block_score=round(block_score, 6),
        width_bucket=next_pow2(max(int(round(mean)), 1)),
    )
