"""setup_s: process start to the first timed operation (CUDA start-up,
the operator built on the device, its structures, the preconditioner's
hierarchy, the inputs and the warm-up), by the host clock."""


def read(ctx):
    return ctx.setup["setup_s"]
