"""gmg.hierarchy_s: host seconds around ``GMG(...)``, synchronised at
both ends: restriction operators, Galerkin products, smoother set-up."""


def read(ctx):
    return ctx.setup.get("hierarchy_s")
