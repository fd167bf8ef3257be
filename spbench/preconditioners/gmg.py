"""``gmg``: the geometric multigrid V-cycle of the program's
``apps/gmg.py`` as the preconditioner ``M`` of a solve.

Parameters: ``levels``, ``smoother`` (``jacobi``), ``gridop``
(``linear``: full-weighting restriction, its transpose the
prolongation) and ``power_iters`` (power iterations for each level's
smoother weight).  The configuration's ``grid`` is the fine grid.
"""

from __future__ import annotations


def build(A, config: dict, params: dict):
    """The hierarchy over ``A`` (Galerkin coarse operators, smoother
    weights), its V-cycle as a linear operator."""
    from legate_sparse_tpu_torch.apps.gmg import GMG

    mg = GMG(A, tuple(config["grid"]), int(params["levels"]),
             params["smoother"], params["gridop"],
             int(params["power_iters"]))
    return mg.linear_operator()
