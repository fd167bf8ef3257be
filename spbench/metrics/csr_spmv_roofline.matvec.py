"""csr_spmv_roofline.matvec: the least time of one product of the
configuration's operator over the device time a product took, in
product cells whose operator family counts its own least bytes
(``operators/<operator>.py::spmv_bytes``: the values, the column
indices and the row offsets read once, x read once and y written
once).  The device time a product is ``matvec_ms`` times the profiled
slice's busy share.  It reads the same work whatever kernel computes
the product."""

from spbench.core import readers, spec, work


def read(ctx):
    t = ctx.trace
    ms = readers.ms_per_unit(ctx, "matvec")
    least_bytes = getattr(spec.part("operators", ctx.config["operator"]),
                          "spmv_bytes", None)
    if t is None or ms is None or least_bytes is None or t.window_s <= 0:
        return None
    device_s = ms * 1e-3 * t.busy_s / t.window_s
    least_s = max(least_bytes(ctx.config) / work.PEAKS["hbm_bytes_per_s"],
                  work.spmv_flops(ctx.config) / work.PEAKS["f32_flops_per_s"])
    return 100.0 * least_s / device_s
