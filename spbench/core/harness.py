"""One run of one cell: set-up, the window, the comparison, the result.

``run`` is the whole of a run after the command line: it takes the
cell by name, builds the configuration's operator on the device (its
family's ``operators/<operator>.py``), builds the preconditioner the
mix names, warms the cell's shapes (its kind's ``kinds/<kind>.py``),
runs the window, reads the device's peak memory, frees the program's
state, compares what the window produced with the plain reference
(``reference/<operator>.py`` and what the kind names), and returns the
result line with the metrics that the cell's readers return.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

import torch

from . import spec, system
from . import profile as _profile
from . import traffic as _traffic

JAX_NAMES = ("jax", "jaxlib", "flax", "legate_sparse_tpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


@dataclass
class Context:
    """What a metric's reader reads."""
    config: dict
    traffic: dict
    kind: str
    setup: Dict[str, float]
    window: _traffic.Window
    trace: Optional[_profile.Trace]


def jax_modules() -> list:
    """Modules loaded under a JAX name, compared by whole top-level
    name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_NAMES))


def build(cell: spec.Cell, device: torch.device, seed: int, trace: bool,
          t_start: float):
    """Set-up: the operator, the preconditioner, the inputs and the
    warm-up.  Returns ``(A, M, mix, setup seconds)``; ``M`` (None
    without a preconditioner) holds the hierarchy."""
    cfg = cell.config
    family = spec.part("operators", cfg["operator"])
    dtype = DTYPES[cfg["dtype"]]
    torch.zeros(1, device=device).add_(1)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    system.load_kernels(device)
    _traffic.sync(device)
    t = time.perf_counter()
    n = family.rows(cfg)
    data, indices, indptr = family.assemble(cfg, dtype, device, seed)
    A = system.operator(data, indices, indptr, (n, n))
    del data, indices, indptr
    system.matvec(A, torch.zeros(n, dtype=dtype, device=device))
    _traffic.sync(device)
    setup = {"operator_s": time.perf_counter() - t}
    M = None
    pre = cell.traffic.get("preconditioner")
    if pre:
        t = time.perf_counter()
        M = spec.part("preconditioners", pre["name"]).build(A, cfg, pre)
        _traffic.sync(device)
        setup["hierarchy_s"] = time.perf_counter() - t
    mix = spec.part("kinds", cell.traffic["kind"]).Mix(
        cell.traffic, cfg, n, device, dtype, seed)
    if trace:
        _profile.warm(device, lambda: mix.prepare(A, M))
    else:
        mix.prepare(A, M)
    _traffic.sync(device)
    setup["setup_s"] = time.perf_counter() - t_start
    return A, M, mix, setup


def compare(cell: spec.Cell, mix: _traffic.Mix, window: _traffic.Window,
            control: bool = False) -> _traffic.Checks:
    """Each number the cell's limits name, on each answer checked:
    the kind's comparison with the configuration's reference (in
    float64; with ``control``, the reference in bfloat16 in the
    program's place)."""
    cfg = cell.config
    ref = spec.part("reference", cfg["operator"]).operator(
        cfg, mix.seed, mix.device)
    return mix.checks(ref, set(cell.limits["checks"]), window, control)


def judge(cell: spec.Cell, found: _traffic.Checks) -> Tuple[dict, Set]:
    """Each number compared (its worst reading) beside its limit, and
    the answers that pass any limit."""
    out, bad = {}, set()
    for name, spec_ in cell.limits["checks"].items():
        per = found.get(name)
        if per is None:
            raise KeyError(f"{cell.name}: no reading of {name!r}")
        limit = spec_["limit"]
        out[name] = {"value": _traffic.worst(per.values()), "limit": limit}
        bad |= {i for i, v in per.items() if not v <= limit}
    return out, bad


def passed(check: dict) -> bool:
    v = check["value"]
    return not (isinstance(v, float) and math.isnan(v)) and \
        v <= check["limit"]


def device_record(device: torch.device, peak: int, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        cell: Optional[spec.Cell] = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    cell = cell or spec.cell(workload)
    A, M, mix, setup = build(cell, device, seed, trace, t_start)
    window = mix.run(A, M, seconds, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del A, M
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = Context(config=cell.config, traffic=cell.traffic,
                  kind=cell.traffic["kind"], setup=setup, window=window,
                  trace=window.trace)
    metrics_spec = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in metrics_spec:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found, bad = judge(cell, compare(cell, mix, window))
    result = {"correct": all(passed(c) for c in found.values()),
              "attempted": window.count, "failed": len(bad),
              "metrics": metrics,
              "device": device_record(device, peak, cell.chips)}
    if trace and window.trace is not None:
        result["device"]["busy_s"] = window.trace.busy_s
        result["device"]["window_s"] = window.trace.window_s
        result["breakdown"] = window.trace.breakdown()
    result["checks"] = found
    return result
