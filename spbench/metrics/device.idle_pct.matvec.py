"""device.idle_pct.matvec: the device's idle share of the profiled slice
(``core/readers.py``), in product cells."""

from spbench.core import readers


def read(ctx):
    return readers.idle_pct(ctx, "matvec")
