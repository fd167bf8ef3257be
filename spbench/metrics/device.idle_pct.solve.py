"""device.idle_pct.solve: the device's idle share of the profiled slice
(``core/readers.py``), in plain solve cells."""

from spbench.core import readers


def read(ctx):
    return readers.idle_pct(ctx, "solve")
