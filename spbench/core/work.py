"""The yardstick's arithmetic: the least work of an operation, counted
from a configuration's definition, and the device peaks it is held to.

Nothing here reads the program: a later change of format, padding or
kernel leaves these counts as they are.
"""

from __future__ import annotations

from . import spec

# Published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM3 bandwidth
# and dense float32 rate outside the tensor cores.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}

VALUE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}


def _family(config: dict):
    return spec.part("operators", config["operator"])


def operator_nnz(config: dict) -> int:
    return _family(config).nnz(config)


def spmv_bytes(config: dict) -> int:
    """Least bytes of ``y = A @ x``: every stored value read once, x
    read once and y written once, in the configuration's value type.
    The indices are left out: a stencil's structure can be computed,
    not read."""
    w = VALUE_BYTES[config["dtype"]]
    n = _family(config).rows(config)
    return operator_nnz(config) * w + 2 * n * w


def spmv_flops(config: dict) -> int:
    return 2 * operator_nnz(config)


def spmv_min_seconds(config: dict) -> float:
    """The least time of one product on the device: the larger of its
    bytes over the bandwidth peak and its operations over the float32
    peak (the bytes bound it)."""
    return max(spmv_bytes(config) / PEAKS["hbm_bytes_per_s"],
               spmv_flops(config) / PEAKS["f32_flops_per_s"])
