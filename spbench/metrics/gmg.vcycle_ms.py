"""gmg.vcycle_ms: CUDA events recorded around each application of the
preconditioner in the solves right after the profiled slice (outside
the profiler, which slows the launch-bound V-cycle): their total over
their count."""


def read(ctx):
    v = ctx.window.vcycle_s
    if ctx.trace is None or not v:
        return None
    return sum(v) * 1e3 / len(v)
