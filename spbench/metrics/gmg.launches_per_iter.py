"""gmg.launches_per_iter: ``cg.launches_per_iter`` of the
GMG-preconditioned solves, V-cycles included."""

from spbench.core import readers


def read(ctx):
    return readers.launches_per_iter(ctx)
