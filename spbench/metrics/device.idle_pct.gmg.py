"""device.idle_pct.gmg: the device's idle share of the profiled slice
(``core/readers.py``), in the GMG-preconditioned cell."""

from spbench.core import readers


def read(ctx):
    return readers.idle_pct(ctx, "solve")
