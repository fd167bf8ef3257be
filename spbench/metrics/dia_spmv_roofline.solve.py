"""dia_spmv_roofline.solve: the operator's least time over the mean
device time of a ``dia_spmv`` launch in the profiled slice of a solve
(``core/readers.py``).  Only where every such launch is a product of
the configuration's operator (plain CG)."""

from spbench.core import readers


def read(ctx):
    return readers.spmv_roofline(ctx, "solve", "dia_spmv")
