"""gmg.cg_iters: ``cg.iters`` of the GMG-preconditioned solves."""

from spbench.core import readers


def read(ctx):
    return readers.mean_iters(ctx)
