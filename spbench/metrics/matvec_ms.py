"""matvec_ms: the window's wall time, ended by a device
synchronisation, over the products dispatched in it."""

from spbench.core import readers


def read(ctx):
    return readers.ms_per_unit(ctx, "matvec")
