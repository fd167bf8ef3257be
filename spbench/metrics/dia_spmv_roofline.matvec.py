"""dia_spmv_roofline.matvec: the operator's least time over the mean
device time of a ``dia_spmv`` launch in the profiled slice of the
products (``core/readers.py``)."""

from spbench.core import readers


def read(ctx):
    return readers.spmv_roofline(ctx, "matvec", "dia_spmv")
