"""solve_ms: the window's wall time over the whole solves it completed
(the window ends when the solve in flight at its length ends)."""

from spbench.core import readers


def read(ctx):
    return readers.ms_per_unit(ctx, "solve")
