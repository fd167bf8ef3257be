# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's GMG app (``legate_sparse_tpu_torch/apps/gmg.py``) against
``examples/gmg.py`` driven by the JAX package.

The example is driven as ``tests/test_examples.py`` drives it: its
``common``/``gmg`` modules imported from ``examples/`` with ``--package
tpu`` (on this CPU lane the JAX package runs in float64).  Both sides
build the hierarchy of ``poisson2D(16)`` with three levels, for both
restriction operators, in float64.  Tolerances: the restriction
operators and the Galerkin operators ``R @ A @ P`` have the same
pattern bit for bit and values at rtol = atol = 1e-12 (ESC adds the
products of a coordinate in another order); one V-cycle agrees at rtol
= atol = 1e-12; GMG-preconditioned CG to rtol 1e-10 takes the same
number of iterations and the solutions agree at rtol 1e-9.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

import legate_sparse_tpu.linalg as jlinalg

from legate_sparse_tpu_torch import interop
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch.apps import gmg as tgmg

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
N = 16
LEVELS = 3


@pytest.fixture(scope="module")
def example():
    """``examples/gmg.py`` bound to the JAX package."""
    sys.path.insert(0, EXAMPLES)
    argv = sys.argv
    sys.argv = ["test", "--package", "tpu"]
    try:
        import common
        import gmg

        common.parse_common_args()
        gmg.np, gmg.sparse, gmg.linalg = common.np, common.sparse, \
            common.linalg
        yield common, gmg
    finally:
        sys.argv = argv
        sys.path.remove(EXAMPLES)


def _parts_close(Aj, At, tol=1e-12):
    dj, ij, pj = (np.asarray(Aj.data), np.asarray(Aj.indices),
                  np.asarray(Aj.indptr))
    dt, it, pt = interop.to_numpy_parts(At)
    assert tuple(Aj.shape) == tuple(At.shape)
    np.testing.assert_array_equal(it.astype(np.int64), ij.astype(np.int64))
    np.testing.assert_array_equal(pt.astype(np.int64), pj.astype(np.int64))
    np.testing.assert_allclose(dt, dj, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def hierarchies(example):
    common, gmg = example
    out = {}
    for gridop in ("linear", "injection"):
        Aj = common.poisson2D(N)
        sj = gmg.GMG(A=Aj, shape=(N, N), levels=LEVELS, smoother="jacobi",
                     gridop=gridop)
        At = tgmg.poisson2D(N, device="cpu")
        st = tgmg.GMG(At, (N, N), LEVELS, "jacobi", gridop)
        out[gridop] = (Aj, sj, At, st)
    return out


def test_poisson2d_matches_example(example):
    common, _ = example
    _parts_close(common.poisson2D(N), tgmg.poisson2D(N, device="cpu"),
                 tol=0.0)


@pytest.mark.parametrize("gridop", ["linear", "injection"])
def test_galerkin_hierarchy_matches_example(gridop, hierarchies):
    _, sj, _, st = hierarchies[gridop]
    assert len(st.operators) == len(sj.operators) == LEVELS
    for (Rj, Acj, Pj), (Rt, Act, Pt) in zip(sj.operators, st.operators):
        _parts_close(Rj, Rt, tol=0.0)
        _parts_close(Pj, Pt, tol=0.0)
        _parts_close(Acj, Act)
    for (wj, dj), (wt, dt) in zip(sj.smoother.level_params,
                                  st.smoother.level_params):
        np.testing.assert_allclose(wt, wj, rtol=1e-12)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-12)
    assert all(p == {"R@A": "esc", "RA@P": "esc"} for p in st.spgemm_paths)


@pytest.mark.parametrize("gridop", ["linear", "injection"])
def test_one_v_cycle_matches_example(gridop, hierarchies):
    _, sj, _, st = hierarchies[gridop]
    r = np.random.default_rng(3).random(N * N)
    np.testing.assert_allclose(st.cycle(torch.from_numpy(r)).numpy(),
                               np.asarray(sj.cycle(r)), rtol=1e-12,
                               atol=1e-12)


def test_gmg_cg_iterations_match_example(hierarchies):
    Aj, sj, At, st = hierarchies["linear"]
    b = np.random.default_rng(0).random(N * N)
    xj, itj = jlinalg.cg(Aj, b, rtol=1e-10, maxiter=200,
                         M=sj.linear_operator())
    xt, itt = tlinalg.cg(At, torch.from_numpy(b), rtol=1e-10, maxiter=200,
                         M=st.linear_operator())
    assert int(itt) == int(itj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9,
                               atol=1e-12)


def test_solve_reports_and_beats_plain_cg():
    out = tgmg.solve(32, 4, gridop="linear", tol=1e-8, device="cpu",
                     compare_plain=True)
    assert out["converged"] and out["rel_residual"] <= 1e-8
    assert out["iters"] < out["plain_iters"]
    assert out["hierarchy"][0] == [256, (3 * 16 - 2) ** 2]   # 9-point
    assert out["spmv_paths"][0]["A"] == "dia-torch"
    assert len(out["spgemm_paths"]) == 4
    # The coarsest operator (2x2 grid, 4 unknowns) is dense: an exact
    # band, so its A @ D^-1 takes the banded route (f64: plain torch).
    assert out["smoother_spgemm_paths"] == ["esc"] * 4 + ["dia-torch"]


def test_solve_watch_wraps_the_gmg_cg_solve_alone(monkeypatch):
    """``watch`` is entered once, around the preconditioned solve: the
    plain CG of ``compare_plain`` runs outside it."""
    calls = []
    inside = [False]
    cg = tlinalg.cg

    def recording_cg(A, b, **kw):
        calls.append((inside[0], kw.get("M") is not None))
        return cg(A, b, **kw)

    @contextlib.contextmanager
    def watch():
        inside[0] = True
        yield
        inside[0] = False

    monkeypatch.setattr(tgmg.linalg, "cg", recording_cg)
    out = tgmg.solve(16, 3, gridop="linear", tol=1e-8, device="cpu",
                     compare_plain=True, watch=watch)
    assert calls == [(True, True), (False, False)]
    assert out["iters"] < out["plain_iters"]
