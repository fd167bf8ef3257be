"""cg.iters: the iterations ``linalg.cg`` returned, summed over the
window's solves, over the solves (plain CG)."""

from spbench.core import readers


def read(ctx):
    return readers.mean_iters(ctx)
