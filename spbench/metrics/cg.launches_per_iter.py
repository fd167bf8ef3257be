"""cg.launches_per_iter: device kernel launches in the profiled slice
(copies and sets left out) over the CG iterations of its solves
(plain CG)."""

from spbench.core import readers


def read(ctx):
    return readers.launches_per_iter(ctx)
