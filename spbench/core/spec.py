"""Find a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cell (its
configuration and traffic mix) and the metrics; everything else is a
file of its own under ``spbench/``, found by that name:

- ``configs/<config>.json``: the configuration; its ``operator`` names
  the operator family, ``operators/<operator>.py`` (its CSR arrays for
  the program, its size and work) with its plain reference
  ``reference/<operator>.py``;
- ``traffic/<traffic>.json``: the traffic mix, data; its ``kind`` names
  the generator that reads it, ``kinds/<kind>.py``.  A mix of the
  ``solve`` kind names its solver (``reference/<solver>.py``) and its
  preconditioner (``preconditioners/<name>.py``, with
  ``reference/<name>.py``);
- ``limits/<workload>.json``: the limits of the cell's comparison;
- ``metrics/<metric>.py``: a reader with ``read(ctx)``, returning the
  metric's value or None where the run holds nothing to read.

Adding a cell or a metric is adding such files and entries in
``BENCHMARK.json``; no file of the harness changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent.parent       # spbench/
ROOT = HERE.parent                                  # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    return _json(HERE / "limits" / f"{workload}.json")


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """Whether ``workload`` reports ``metric``: the cells its
    ``workloads`` key lists, else every cell that reports the
    end-to-end metric it moves (or, for an end-to-end metric, every
    cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def cell(workload: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"]
           if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(name=workload, chips=int(entry["chips"]),
                config=_json(root / cfg["file"]),
                traffic=traffic(entry["traffic"]), limits=limits(workload),
                end_to_end=e2e, per_layer=per_layer)


def part(folder: str, name: str):
    """The module ``spbench/<folder>/<name>.py``: an operator family, a
    traffic kind, a preconditioner or a reference."""
    if not name.isidentifier():
        raise ValueError(f"{folder}/{name}.py: not a module name")
    return importlib.import_module(f"spbench.{folder}.{name}")


def reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "spbench.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

