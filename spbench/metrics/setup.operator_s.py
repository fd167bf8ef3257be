"""setup.operator_s: host seconds from the start of the operator's
assembly on the device to its first product, synchronised: the CSR
arrays, ``csr_array(...)`` and the structures the first ``A @ x``
builds (the DIA band and its pack)."""


def read(ctx):
    return ctx.setup["operator_s"]
