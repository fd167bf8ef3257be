# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""A plain reference of the Graph500 Kronecker graph (specification
3.0's generator, ``kronecker_generator.m``), for the tests: plain
PyTorch, importing neither JAX nor the port.

The same graph as the benchmark's ``kronecker`` family draws on one
kind of device: ``scale`` levels a generated edge, each setting a bit
of its row with probability C + D and a bit of its column with
probability D / (C + D) after a set row bit, else B / (A + B); the
labels then mapped through one random permutation; weights uniform in
[0, 1).  Edges come in chunks of ``CHUNK``, each from its own generator
seeded by ``derive(graph_seed, "edges", k)``.

The matrix is the undirected graph's: self-loops dropped, each edge
stored both ways, duplicates summed.  ``assemble`` gives it as CSR
arrays (float64 values, int32 columns, int64 row pointers); ``apply``
computes ``A @ x`` from the edge list alone in float64.
"""

from __future__ import annotations

import hashlib

import torch

CHUNK = 1 << 24
INITIATOR = (0.57, 0.19, 0.19, 0.05)


def derive(seed: int, *parts) -> int:
    """A 63-bit seed from ``seed`` and ``parts``."""
    h = hashlib.blake2b(":".join(str(p) for p in (seed,) + parts).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def quadrant_bits(scale: int, graph_seed: int, k: int = 0,
                  edge_factor: int = 16, initiator=INITIATOR):
    """Chunk ``k`` before the permutation: ``(i, j, w)``."""
    a, b, c, _ = initiator
    ab = a + b
    m = min(CHUNK, edge_factor * (1 << scale) - k * CHUNK)
    g = _gen(derive(graph_seed, "edges", k))
    i = torch.zeros(m, dtype=torch.int64)
    j = torch.zeros(m, dtype=torch.int64)
    for level in range(scale):
        i_bit = torch.rand(m, generator=g) > ab
        j_bit = torch.rand(m, generator=g) > torch.where(
            i_bit, c / (1.0 - ab), a / ab)
        i |= i_bit.to(torch.int64) << level
        j |= j_bit.to(torch.int64) << level
    return i, j, torch.rand(m, generator=g)


def permutation(scale: int, graph_seed: int) -> torch.Tensor:
    return torch.randperm(1 << scale, generator=_gen(derive(graph_seed,
                                                            "perm")))


def edge_list(scale: int, graph_seed: int, edge_factor: int = 16):
    """Every generated edge, labels permuted, loops and duplicates
    kept: ``(i, j, w)``."""
    perm = permutation(scale, graph_seed)
    parts = [quadrant_bits(scale, graph_seed, k, edge_factor)
             for k in range(-(-edge_factor * (1 << scale) // CHUNK))]
    i, j, w = (torch.cat(t) for t in zip(*parts))
    return perm[i], perm[j], w


def _undirected(scale: int, graph_seed: int):
    i, j, w = edge_list(scale, graph_seed)
    keep = i != j
    i, j, w = i[keep], j[keep], w[keep].to(torch.float64)
    return torch.cat([i, j]), torch.cat([j, i]), torch.cat([w, w])


def assemble(scale: int, graph_seed: int):
    """``(data, indices, indptr)``: sorted by (row, column), duplicates
    summed, float64 values."""
    row, col, w = _undirected(scale, graph_seed)
    n = 1 << scale
    key, inverse = torch.unique(row * n + col, return_inverse=True)
    data = torch.zeros(key.shape[0], dtype=torch.float64).index_add_(
        0, inverse, w)
    indptr = torch.zeros(n + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(torch.bincount(key // n, minlength=n), 0)
    return data, (key % n).to(torch.int32), indptr


def apply(scale: int, graph_seed: int, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in float64, scattered from the edge list."""
    row, col, w = _undirected(scale, graph_seed)
    return torch.zeros(1 << scale, dtype=torch.float64).index_add_(
        0, row, w * x.to(torch.float64)[col])
