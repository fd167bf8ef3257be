# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The closed semiring catalog the graph layer computes over.

Counterpart of ``legate_sparse_tpu/graph/semiring.py``.  A semiring
(add, multiply, additive identity) generalises the matrix-vector
product: ``y[i] = ADD_j data[i, j] MUL x[j]`` over the stored entries
of row ``i``.

=============  =====  ========  ==================  =================
name           add    multiply  additive identity   algorithm
=============  =====  ========  ==================  =================
``plus-times`` sum    a * x     0                   PageRank / linalg
``min-plus``   min    a + x     +inf                SSSP, CC labels
``max-times``  max    a * x     -inf                widest/best path
``or-and``     or     a AND x   False               BFS frontiers
=============  =====  ========  ==================  =================

In every entry the additive identity is also the multiplicative
annihilator, which is what lets a padded slot's product be masked to
the identity and absorbed by the row's reduction (the plus-times
products' discipline: mask the product, never the operand).  ``or`` is
``max`` over booleans.  ``collective`` names the cross-shard
all-reduce of the 2-d-block distributed product (psum ->
pmin/pmax/por), which is also its ``comm.dist_spmv.<kind>`` counter.
The ``or-and`` multiply is structural: a stored entry is an edge
(csgraph's explicit-zero convention), so the product is the gathered
frontier bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Union

import torch

from ..ops.spmv import semiring_identity


@dataclass(frozen=True)
class Semiring:
    """One closed semiring: the (add, multiply) pair, and the
    collective its 2-d-block distributed product reduces with."""

    name: str
    add: str             # row reduction: "sum" | "min" | "max"
    mul: str             # product: "times" | "plus" | "and"
    collective: str      # cross-shard all-reduce / comm counter kind

    def identity(self, dtype: torch.dtype, device=None) -> torch.Tensor:
        """The additive identity as a 0-d tensor of ``dtype``: the value
        a padded slot is masked to."""
        return semiring_identity(self.add, dtype, device)

    def annihilator(self, dtype: torch.dtype, device=None) -> torch.Tensor:
        """The multiplicative annihilator (the additive identity in this
        catalog; its own accessor so callers state the role they
        mean)."""
        return self.identity(dtype, device)


PLUS_TIMES = Semiring("plus-times", add="sum", mul="times",
                      collective="psum")
MIN_PLUS = Semiring("min-plus", add="min", mul="plus", collective="pmin")
MAX_TIMES = Semiring("max-times", add="max", mul="times",
                     collective="pmax")
OR_AND = Semiring("or-and", add="max", mul="and", collective="por")

SEMIRINGS: Dict[str, Semiring] = {
    s.name: s for s in (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)
}


def resolve(semiring: Union[str, Semiring]) -> Semiring:
    """The catalog entry of a name; a ``Semiring`` passes through (a
    user-defined one with the same ``add``/``mul`` vocabulary runs on
    the same products)."""
    if isinstance(semiring, Semiring):
        return semiring
    try:
        return SEMIRINGS[semiring]
    except KeyError:
        raise ValueError(
            f"unknown semiring {semiring!r}; catalog: "
            f"{sorted(SEMIRINGS)}") from None
