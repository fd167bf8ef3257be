# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package, and with no CUDA device it runs only where the caller asks
for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import legate_sparse_tpu_torch as sparse
from legate_sparse_tpu_torch import runtime

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "legate_sparse_tpu_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in PKG.rglob("*.py")) + ["bench_torch.py",
                                                   "chip_smoke.py",
                                                   "chip_spgemm_ab.py"]
# ``bench`` and ``examples``' modules (``common`` among them) and the
# repo's ``tools`` import the JAX package at run time: the port keeps its
# own copies.
FORBIDDEN = ("jax", "jaxlib", "legate_sparse_tpu", "bench", "common",
             "examples", "tools")


def _forbidden(module: str) -> bool:
    # Exact top-level name: ``legate_sparse_tpu_torch`` shares a prefix
    # with ``legate_sparse_tpu`` and is allowed.
    return module.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import legate_sparse_tpu_torch\n"
        "import legate_sparse_tpu_torch.apps.common\n"
        "import legate_sparse_tpu_torch.apps.gmg\n"
        "import legate_sparse_tpu_torch.apps.pde\n"
        "import legate_sparse_tpu_torch.apps.spectral\n"
        "import legate_sparse_tpu_torch.apps.spgemm_microbenchmark\n"
        "import legate_sparse_tpu_torch.apps.spmv_microbenchmark\n"
        "import legate_sparse_tpu_torch.bench_timing\n"
        "import bench_torch\n"
        "import legate_sparse_tpu_torch.base\n"
        "import legate_sparse_tpu_torch.coo\n"
        "import legate_sparse_tpu_torch.coverage\n"
        "import legate_sparse_tpu_torch.csc\n"
        "import legate_sparse_tpu_torch.csgraph\n"
        "import legate_sparse_tpu_torch.delta\n"
        "import legate_sparse_tpu_torch.delta.dist\n"
        "import legate_sparse_tpu_torch.eigen\n"
        "import legate_sparse_tpu_torch._lobpcg\n"
        "import legate_sparse_tpu_torch.expm\n"
        "import legate_sparse_tpu_torch.gallery\n"
        "import legate_sparse_tpu_torch.graph\n"
        "import legate_sparse_tpu_torch.graph.algorithms\n"
        "import legate_sparse_tpu_torch.interop\n"
        "import legate_sparse_tpu_torch.io\n"
        "import legate_sparse_tpu_torch.krylov_extra\n"
        "import legate_sparse_tpu_torch.module\n"
        "import legate_sparse_tpu_torch.obs\n"
        "import legate_sparse_tpu_torch.obs.comm\n"
        "import legate_sparse_tpu_torch.obs.export\n"
        "import legate_sparse_tpu_torch.obs.memory\n"
        "import legate_sparse_tpu_torch.parallel\n"
        "import legate_sparse_tpu_torch.parallel.launch\n"
        "import legate_sparse_tpu_torch.precond\n"
        "import legate_sparse_tpu_torch.utils_native\n"
        "import legate_sparse_tpu_torch.ops.bsr\n"
        "import legate_sparse_tpu_torch.ops.dia_kernel\n"
        "import legate_sparse_tpu_torch.ops.spgemm\n"
        "import legate_sparse_tpu_torch.autotune\n"
        "import legate_sparse_tpu_torch.autotune.fingerprint\n"
        "import legate_sparse_tpu_torch.autotune.harness\n"
        "import legate_sparse_tpu_torch.autotune.registry\n"
        "import legate_sparse_tpu_torch.autotune.store\n"
        "import legate_sparse_tpu_torch.engine\n"
        "import legate_sparse_tpu_torch.engine.buckets\n"
        "import legate_sparse_tpu_torch.engine.core\n"
        "import legate_sparse_tpu_torch.engine.executor\n"
        "import legate_sparse_tpu_torch.engine.gateway\n"
        "import legate_sparse_tpu_torch.engine.plan_cache\n"
        "import legate_sparse_tpu_torch.obs.context\n"
        "import legate_sparse_tpu_torch.obs.attrib\n"
        "import legate_sparse_tpu_torch.obs.capacity\n"
        "import legate_sparse_tpu_torch.obs.doctor\n"
        "import legate_sparse_tpu_torch.obs.regress\n"
        "import legate_sparse_tpu_torch.obs.report\n"
        "import legate_sparse_tpu_torch.obs.slo\n"
        "import legate_sparse_tpu_torch.placement\n"
        "import legate_sparse_tpu_torch.placement.controller\n"
        "import legate_sparse_tpu_torch.placement.migrate\n"
        "import legate_sparse_tpu_torch.placement.submesh\n"
        "import legate_sparse_tpu_torch.resilience\n"
        "import legate_sparse_tpu_torch.resilience.chaos\n"
        "import legate_sparse_tpu_torch.resilience.checkpoint\n"
        "import legate_sparse_tpu_torch.resilience.deadline\n"
        "import legate_sparse_tpu_torch.resilience.faults\n"
        "import legate_sparse_tpu_torch.resilience.health\n"
        "import legate_sparse_tpu_torch.resilience.outcomes\n"
        "import legate_sparse_tpu_torch.resilience.policy\n"
        "import legate_sparse_tpu_torch.tools\n"
        "import legate_sparse_tpu_torch.tools.bench_compare\n"
        "import legate_sparse_tpu_torch.tools.trace_summary\n"
        "import legate_sparse_tpu_torch.tools.tune_irregular\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'legate_sparse_tpu', 'bench',\n"
        "                                    'common', 'examples',\n"
        "                                    'tools'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("relpath", PORT_FILES)
def test_no_jax_import_in_source(relpath):
    tree = ast.parse((ROOT / relpath).read_text(), filename=relpath)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{relpath} imports {bad}"


FACADE_NAMES = ("coo_array", "coo_matrix", "csc_array", "csc_matrix",
                "csr_matrix", "dia_matrix", "eye", "identity", "kron",
                "kronsum", "tril", "triu", "spdiags", "vstack", "hstack",
                "block_diag", "bmat", "block_array", "find", "random",
                "powerlaw", "rmat", "SparseEfficiencyWarning")


def test_facade_names_exported_without_jax():
    """The facade's names come from the port's own modules."""
    for name in FACADE_NAMES:
        obj = getattr(sparse, name)
        assert getattr(obj, "__module__", "").startswith(
            ("legate_sparse_tpu_torch", "scipy")), (name, obj)


def test_forbidden_matches_exact_module_names():
    assert _forbidden("jax.numpy")
    assert _forbidden("legate_sparse_tpu.ops.bsr")
    assert _forbidden("bench") and _forbidden("examples.common")
    assert _forbidden("tools.bench_compare")
    assert not _forbidden("legate_sparse_tpu_torch.ops.bsr")
    assert not _forbidden("legate_sparse_tpu_torch.tools.trace_summary")
    assert not _forbidden("bench_torch")


def test_one_copy_of_time_ms():
    """The kernel timer lives in ``bench_timing.py`` alone; the chip
    scripts import it."""
    defs = [rel for rel in PORT_FILES
            if any(isinstance(n, ast.FunctionDef) and n.name == "time_ms"
                   for n in ast.walk(ast.parse((ROOT / rel).read_text())))]
    assert defs == ["legate_sparse_tpu_torch/bench_timing.py"]
    assert "from legate_sparse_tpu_torch.bench_timing import" in (
        ROOT / "chip_smoke.py").read_text()
    assert "bench_timing.py" in (ROOT / "chip_spgemm_ab.py").read_text()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runtime.set_device(None)
    yield
    runtime.set_device(None)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse.diags([1.0, 2.0, 3.0], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse.csr_array(np.eye(3))


def test_cpu_on_request(no_cuda):
    A = sparse.diags([1.0, 2.0, 3.0], 0, device="cpu")
    assert A.device.type == "cpu"
    runtime.set_device("cpu")
    B = sparse.csr_array(np.eye(3))
    assert B.device.type == "cpu"
    y = B @ np.ones(3)
    assert y.device.type == "cpu" and B.spmv_path == "dia-torch"


def test_tensor_inputs_keep_their_device(no_cuda):
    A = sparse.csr_array(torch.eye(4, dtype=torch.float32))
    assert A.device.type == "cpu"


@pytest.mark.parametrize("make", [
    lambda: sparse.coo_array(np.eye(3)),
    lambda: sparse.coo_array((np.ones(2), (np.arange(2), np.arange(2)))),
    lambda: sparse.csc_array(np.eye(3)),
    lambda: sparse.eye(3), lambda: sparse.identity(3),
    lambda: sparse.spdiags(np.ones((1, 3)), [0]),
    lambda: sparse.random(4, 4, density=0.5, rng=0),
    lambda: sparse.powerlaw(8, rng=0), lambda: sparse.rmat(3, rng=0)])
def test_facade_entry_points_raise_without_cuda(no_cuda, make):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_tools_run_on_cuda_unless_asked(no_cuda):
    """``tune_irregular`` runs on ``cuda`` by default and raises without
    a card; ``bench_compare`` and ``trace_summary`` read files only."""
    from legate_sparse_tpu_torch.tools import tune_irregular

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_irregular.main(["--smoke"])
    for name in ("bench_compare", "trace_summary"):
        tree = ast.parse((PKG / "tools" / f"{name}.py").read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)]
        assert not [m for m in mods if m.split(".")[0] == "torch"], mods


def test_facade_entry_points_on_request(no_cuda):
    for A in (sparse.eye(3, device="cpu"), sparse.rmat(3, rng=0,
                                                        device="cpu"),
              sparse.csc_array(np.eye(3), device="cpu"),
              sparse.coo_array(np.eye(3), device="cpu")):
        assert A.device.type == "cpu"
    runtime.set_device("cpu")
    assert sparse.random(4, 4, density=0.5, rng=0).device.type == "cpu"
    assert sparse.kron(np.eye(2), np.eye(2)).device.type == "cpu"
