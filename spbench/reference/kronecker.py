"""The plain reference of the ``kronecker`` operator family: the
weighted adjacency matrix of a Graph500 Kronecker graph.

A configuration gives ``scale`` (2^scale vertices), ``edge_factor``
(edge_factor * 2^scale generated edges), ``initiator`` (the quadrant
probabilities A, B, C, D) and ``graph_seed``.  The graph, as the
Graph500 specification 3.0 generates it (its octave reference,
``kronecker_generator.m``):

- each edge picks one quadrant a level, for ``scale`` levels: a bit of
  its row is set with probability C + D, then a bit of its column with
  probability D / (C + D) if the row's bit is set, else B / (A + B);
  level ``k`` sets bit ``k`` (two uniform draws a level);
- every label is then mapped through one random permutation of the
  2^scale vertices, so no block structure is left;
- each edge carries a weight uniform in [0, 1) (kernel 3's SSSP
  weights).

The specification also shuffles the edge list; the matrix is the same
multiset of edges in any order, so nothing here shuffles it.

The edges come in fixed chunks of ``CHUNK``, each drawn on the device
from its own generator seeded by ``derive(graph_seed, "edges", k)``,
and the permutation from ``derive(graph_seed, "perm")``: any chunk can
be drawn again alone.  The same seeds give the same graph on one kind
of device; a CPU and a CUDA generator draw different streams.

The matrix ``A`` is the undirected graph's: self-loops dropped, each
edge stored both ways, ``A[i, j]`` the sum of the weights of every
generated edge between i and j (scipy's rule for duplicates).
``operator(config, seed, device)`` computes ``A @ x`` from the edge
list alone (``apply``), by scattering each edge's two products with
``index_add_``; it never builds or reads a CSR.  Nothing here imports
the program.  The control (``apply(x, torch.bfloat16)``) is the same
scatter with x, the weights and the sums in bfloat16, one precision
rung below the configurations' float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.traffic import derive

# Edges drawn by one generator: a property of the graph, not a tuning.
CHUNK = 1 << 24


def vertices(config: dict) -> int:
    return 1 << int(config["scale"])


def edges(config: dict) -> int:
    """Generated edges, self-loops and duplicates included."""
    return int(config["edge_factor"]) * vertices(config)


def chunks(config: dict) -> int:
    return -(-edges(config) // CHUNK)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def quadrant_bits(config: dict, k: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk ``k`` before the label permutation: ``(i, j, w)``, int64
    vertex numbers built bit by bit and float32 weights."""
    scale = int(config["scale"])
    a, b, c, _ = (float(p) for p in config["initiator"])
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    m = min(CHUNK, edges(config) - k * CHUNK)
    g = _generator(derive(int(config["graph_seed"]), "edges", k), device)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        i_bit = torch.rand(m, generator=g, device=device) > ab
        j_bit = torch.rand(m, generator=g, device=device) > torch.where(
            i_bit, c_norm, a_norm)
        i |= i_bit.to(torch.int64) << level
        j |= j_bit.to(torch.int64) << level
    w = torch.rand(m, generator=g, device=device)
    return i, j, w


def permutation(config: dict, device) -> torch.Tensor:
    """The vertex labels' permutation (int64)."""
    g = _generator(derive(int(config["graph_seed"]), "perm"), device)
    return torch.randperm(vertices(config), generator=g, device=device)


def chunk(config: dict, k: int, perm: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk ``k`` of the edge list, labels permuted, self-loops kept:
    ``(i, j, w)``."""
    i, j, w = quadrant_bits(config, k, perm.device)
    return perm[i], perm[j], w


class Operator:
    """The reference of one configuration on one device."""

    def __init__(self, config: dict, device):
        self.config = config
        self.device = torch.device(device)
        self.n = vertices(config)
        self.perm = permutation(config, self.device)

    def edges(self):
        """Each chunk's ``(i, j, w)`` with its self-loops dropped."""
        for k in range(chunks(self.config)):
            i, j, w = chunk(self.config, k, self.perm)
            keep = i != j
            yield i[keep], j[keep], w[keep]

    def apply(self, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``A @ x`` in ``dtype`` (float64 by default) for x of shape
        (n,) or (n, k): every edge (i, j, w) adds ``w x[j]`` to row i
        and ``w x[i]`` to row j."""
        dtype = dtype or torch.float64
        xs = x.to(self.device, dtype)
        y = torch.zeros(xs.shape, dtype=dtype, device=self.device)
        for i, j, w in self.edges():
            w = w.to(dtype)
            if xs.dim() == 2:
                w = w[:, None]
            y.index_add_(0, i, w * xs[j])
            y.index_add_(0, j, w * xs[i])
        return y

    def matrix(self) -> torch.Tensor:
        """A as a float64 sparse CSR tensor, its duplicates summed by
        ``coalesce`` (for tests)."""
        rows, cols, vals = [], [], []
        for i, j, w in self.edges():
            rows += [i, j]
            cols += [j, i]
            vals += [w.double(), w.double()]
        A = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
            (self.n, self.n)).coalesce()
        return A.to_sparse_csr()


def operator(config: dict, seed: int, device) -> Operator:
    """The family's reference as the harness finds it.  The graph is
    fixed by ``graph_seed``; the run's ``seed`` draws only x."""
    return Operator(config, device)


def stored_entries(config: dict, device="cpu") -> int:
    """Entries of A, counted from the edge list: the distinct ordered
    pairs (i, j), i != j, that an edge touches."""
    op = Operator(config, device)
    scale = int(config["scale"])
    keys = []
    for i, j, _ in op.edges():
        keys += [(i << scale) | j, (j << scale) | i]
    return int(torch.unique(torch.cat(keys)).shape[0]) if keys else 0

