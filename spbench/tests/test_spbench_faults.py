"""``correct`` comes out false where it must, at a test size on the CPU.

- The control: the reference computed in bfloat16, one rung below the
  configurations' float32, put in the program's place, reads above
  each cell's limit, where the program reads below it (the answers;
  and in the GMG cell the preconditioner's applications).
- The faults: a run with the timed path broken underneath (the
  program's ``linalg.cg`` or ``csr_array.__matmul__`` replaced by a
  broken one) comes out not correct, for each fault a cell can have:
  the state returned unchanged (a solve that returns its start x0, a
  product that returns x), half of the answer left out, and one entry
  of the answer altered where it is produced.  One card, so no
  exchange between cards to leave out.
- Two more of a solve: the V-cycle with its post-smoothing left out
  (``precond_rel_err``), and a plain CG solve stopped at ten times its
  ``rtol`` (``iters_short``).

The chip's own readings of the control and of the early stop, at each
cell's size on three seeds, are ``python3 spbench/calibrate.py`` (see
the README).
"""

import time

import pytest
import torch

import legate_sparse_tpu_torch as lst
from legate_sparse_tpu_torch import linalg
from legate_sparse_tpu_torch.apps import gmg as program_gmg
from spbench.core import harness, spec
from spbench.core import traffic as _traffic

from .test_spbench_harness import TINY, run_tiny, tiny_cell

SEEDS = (2 ** 31 + 3, 2 ** 31 + 29, 2 ** 31 + 101)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_reads_above_the_limit(workload):
    cell = tiny_cell(workload)
    dev = torch.device("cpu")
    A, M, mix, _ = harness.build(cell, dev, SEEDS[0], False,
                                 time.perf_counter())
    kind = spec.part("kinds", cell.traffic["kind"])
    for seed in SEEDS:
        mix = kind.Mix(cell.traffic, cell.config, mix.n, dev, torch.float32,
                       seed)
        mix.prepare(A, M)
        window = mix.run(A, M, 0.2, False)
        program = harness.compare(cell, mix, window)
        control = harness.compare(cell, mix, window, control=True)
        assert control, workload
        for name, per in control.items():
            limit = cell.limits["checks"][name]["limit"]
            p = _traffic.worst(program[name].values())
            c = _traffic.worst(per.values())
            assert p <= limit < c, (seed, name, p, limit, c)


def unchanged(out, arg):
    return torch.zeros_like(out) if isinstance(arg, tuple) else arg.clone()


def half(out, arg):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def altered(out, arg):
    out = out.clone()
    out[out.shape[0] // 3] += 0.01 * float(out.abs().max())
    return out


FAULTS = {"state_unchanged": unchanged, "half_left_out": half,
          "answer_altered": altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(TINY))
def test_fault_makes_the_run_not_correct(workload, fault, monkeypatch):
    breaks = FAULTS[fault]
    if harness.spec.cell(workload).traffic["kind"] == "solve":
        cg = linalg.cg

        def broken_cg(A, b, **kw):
            x, it = cg(A, b, **kw)
            return breaks(x, (b,)), it

        monkeypatch.setattr(linalg, "cg", broken_cg)
    else:
        matmul = lst.csr_array.__matmul__

        def broken_matmul(self, x):
            return breaks(matmul(self, x), x)

        monkeypatch.setattr(lst.csr_array, "__matmul__", broken_matmul)
    r = run_tiny(workload)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0
    assert r["checks"]["max_rel_err"]["value"] > \
        r["checks"]["max_rel_err"]["limit"]


def test_vcycle_without_post_smoothing_is_not_correct(monkeypatch):
    monkeypatch.setattr(program_gmg.WeightedJacobi, "post",
                        lambda self, A, r, x, level: x)
    r = run_tiny("poisson2d-8192.gmg")
    assert not r["correct"], r["checks"]
    c = r["checks"]["precond_rel_err"]
    assert c["value"] > c["limit"]


def test_solve_stopped_early_is_not_correct(monkeypatch):
    """Plain CG on a 192 x 192 Poisson grid at the cell's own ``rtol``
    and convergence test: stopped at ten times ``rtol`` it takes some 50
    iterations fewer than the reference needs."""
    cell = spec.cell("hpcg-256.cg")
    cell.config = dict(spec.config("poisson2d-4096"), grid=[192, 192])
    cg = linalg.cg

    def early(A, b, rtol, **kw):
        return cg(A, b, rtol=10 * rtol, **kw)

    def run():
        return harness.run("hpcg-256.cg", 2 ** 31 + 7, 0.3, False,
                           torch.device("cpu"), time.perf_counter(),
                           cell=cell)

    honest = run()
    assert honest["correct"], honest["checks"]
    monkeypatch.setattr(linalg, "cg", early)
    r = run()
    assert not r["correct"], r["checks"]
    c = r["checks"]["iters_short"]
    assert c["value"] > c["limit"]
