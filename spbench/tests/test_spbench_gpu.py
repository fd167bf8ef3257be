"""The harness on the card at a test size: one traced and one untraced
run of each cell's traffic, through the program's CUDA kernels.

Marked ``gpu``: each test skips without a CUDA device (decided in the
``cuda`` fixture).  On the card::

    python -m pytest -p no:cacheprovider -m gpu spbench/tests
"""

import time

import pytest
import torch

from spbench.core import harness

from .test_spbench_harness import TINY, tiny_cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_on_the_card(workload, cuda):
    cell = tiny_cell(workload)
    plain = harness.run(workload, 2 ** 31 + 17, 0.5, False, cuda,
                        time.perf_counter(), cell=cell)
    assert plain["correct"], plain["checks"]
    assert plain["device"]["platform"] == "gpu"
    assert plain["device"]["memory_peak_bytes"] > 0
    assert {m["name"] for m in cell.end_to_end} == set(plain["metrics"])
    traced = harness.run(workload, 2 ** 31 + 19, 0.5, True, cuda,
                         time.perf_counter(), cell=cell)
    assert traced["correct"], traced["checks"]
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert traced["breakdown"]["device_ops"]
    metrics = traced["metrics"]
    assert {m["name"] for m in cell.per_layer} == set(metrics)
    for name, m in metrics.items():
        assert m["value"] > 0 or "idle" in name, (name, m)
        if m["unit"] == "%":
            assert m["value"] <= 105, (name, m)
