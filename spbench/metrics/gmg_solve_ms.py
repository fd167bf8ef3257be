"""gmg_solve_ms: ``solve_ms`` of the GMG-preconditioned cell, a metric of
its own: a V-cycle launches some 150 kernels an iteration, so its time
spreads with the host's speed more than a plain solve's does, and a
bound of its own keeps that spread out of ``solve_ms``."""

from spbench.core import readers


def read(ctx):
    return readers.ms_per_unit(ctx, "solve")
