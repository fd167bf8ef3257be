# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""``bench_torch.py`` and ``legate_sparse_tpu_torch.bench_timing`` on the
CPU.

- ``bench_torch._banded_config``/``_irregular_config``/``_engine_config``/
  ``_dist2d_config`` equal ``bench.py``'s called with the JAX package,
  bit for bit (values, indices, indptr);
- ``bench_timing``'s loop timer returns a positive time on the CPU and
  raises on a step that does no work; ``time_ms`` is positive;
- one ``python bench_torch.py --smoke --device cpu`` run (tracing on,
  its distributed phases on 8 gloo ranks): exit 0, one JSON line last
  with every headline field and every field of the twelve phases ported
  from ``bench.py`` (``schema_version`` 20), its trace artifact written
  with every phase's span, its deterministic headline fields equal to
  what the port's API gives at the same sizes, and each field of
  ``tests/test_bench_smoke.py``'s ``GOLDEN_FIELDS`` equal to the JAX
  golden (``evidence/BENCH_golden_smoke.json``) through the port's
  ``obs.regress.compare`` (1% on ``*_comm_bytes``), but for the
  ``DIVERGENT`` fields, each explained by a ROADMAP queue-3 item and
  held to the port's own value by a test of its own;
- without a GPU and without ``--device cpu`` the bench raises and
  prints no result; a phase that raises, in the bench's process or on
  a rank, ends the run.
"""

import fnmatch
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import legate_sparse_tpu as jsparse

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.obs import regress
from legate_sparse_tpu_torch.ops import kernel_wrappers
from legate_sparse_tpu_torch.bench_timing import (fixed_cost_s,
                                                  loop_ms_per_iter, time_ms,
                                                  triad_gbs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402
import bench_torch  # noqa: E402

from test_bench_smoke import GOLDEN_FIELDS  # noqa: E402
from test_torch_examples import _same_parts  # noqa: E402

GOLDEN = json.loads((ROOT / "evidence" / "BENCH_golden_smoke.json")
                    .read_text())
# The golden's fields that GOLDEN_FIELDS selects (its ``*_comm_bytes``
# pattern expanded), as ``tools/bench_compare.py --fields`` gates them.
GATED = sorted(k for k, v in GOLDEN.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)
               and any(fnmatch.fnmatch(k, pat)
                       for pat in GOLDEN_FIELDS.split(",")))
# Fields that differ from the JAX golden by design: ROADMAP queue-3 item,
# and the port's own smoke value (deterministic: counts of its wire and
# of its blocks at 8 ranks).
DIVERGENT = {
    # The port's comm.dist_spgemm.* count the collectives it sends; the
    # JAX package's hold its prediction of its three padded phases.
    "dist2d_spgemm_1d_comm_bytes": (13, 1642816),
    "dist2d_spgemm_comm_bytes": (13, 993744),
    # The bytes of the survivors' new blocks; the JAX package's is its
    # shard upload delta.
    "resil_reshard_bytes": (16, 602994),
}


@pytest.mark.parametrize("n, dtype", [(64, "float32"), (1000, "float32"),
                                      (777, "bfloat16")])
def test_banded_config_matches_bench(n, dtype):
    import jax.numpy as jnp

    Aj = bench._banded_config(jsparse, n, 11, dtype=getattr(jnp, dtype))
    At = bench_torch._banded_config(tsparse, n, 11,
                                    dtype=getattr(torch, dtype),
                                    device="cpu")
    _same_parts(Aj, At)


@pytest.mark.parametrize("n", [1 << 10, 1 << 14])
def test_irregular_config_matches_bench(n):
    _same_parts(bench._irregular_config(jsparse, n, 11),
                bench_torch._irregular_config(tsparse, n, 11, device="cpu"))


@pytest.mark.parametrize("seed", [7, 13, 29])
@pytest.mark.parametrize("n", [(1 << 10) - 37, (1 << 14) - 91])
def test_engine_config_matches_bench(n, seed):
    _same_parts(bench._engine_config(jsparse, n, 11, seed=seed),
                bench_torch._engine_config(tsparse, n, 11, seed=seed,
                                           device="cpu"))


@pytest.mark.parametrize("n", [1 << 10, 1 << 14])
def test_dist2d_config_matches_bench(n):
    _same_parts(bench._dist2d_config(jsparse, n, 11),
                bench_torch._dist2d_config(tsparse, n, 11, device="cpu"))


def test_loop_ms_per_iter_on_cpu():
    x = torch.ones(1 << 16)
    ms = loop_ms_per_iter(lambda v: v * 1.0000001 + 1e-9, x, k_lo=5,
                          k_hi=200)
    assert np.isfinite(ms) and ms > 0
    assert fixed_cost_s(x) > 0
    assert time_ms(lambda: x * 2.0, reps=3, device="cpu") > 0
    assert triad_gbs(16, device="cpu") > 0


def test_loop_ms_per_iter_raises_without_work():
    """A step that does no work is never measurably slower at more trip
    counts: ``unresolvable timing``, not a clamped number."""
    x = torch.ones(4)
    with pytest.raises(RuntimeError, match="unresolvable timing"):
        loop_ms_per_iter(lambda v: v, x, k_lo=5, k_cap=15)


def test_loop_timing_frozen_clock_raises(monkeypatch):
    """A clock that never moves (a sub-resolution low point, as
    ``tests/test_advice_r4.py`` pins for the JAX timer): with ``k_hi``
    None no division by zero, and the loud ``unresolvable timing``."""
    from legate_sparse_tpu_torch import bench_timing

    monkeypatch.setattr(bench_timing.time, "perf_counter", lambda: 1.0)
    with pytest.raises(RuntimeError, match="unresolvable timing"):
        loop_ms_per_iter(lambda v: v * 1.0, torch.ones(8), k_lo=2,
                         k_hi=None, k_cap=8, deadline_s=5.0)


def test_loop_timing_noise_dominated_break_raises(monkeypatch):
    """t_hi above t_lo but under the noise floor at the k_cap break:
    raise, not the noise slope (the JAX timer's clock of
    ``tests/test_advice_r4.py``)."""
    from legate_sparse_tpu_torch import bench_timing

    state = {"i": 0}

    def fake_clock():
        state["i"] += 1
        i = state["i"]
        return i * 1e-6 + i * i * 1e-9

    monkeypatch.setattr(bench_timing.time, "perf_counter", fake_clock)
    with pytest.raises(RuntimeError, match="unresolvable"):
        loop_ms_per_iter(lambda v: v * 1.0, torch.ones(8), k_lo=2, k_hi=4,
                         k_cap=4)


def test_loop_timing_decides_on_agreed_times():
    """With ``agree`` the trip counts follow the agreed times, not this
    process's clock (the ranks of a job must all take them): the job's
    first high point does not resolve, so the loop re-aims once and
    returns the agreed slope."""
    agreed = iter([1e-6, 0.010, 0.011, 0.090])   # fixed, lo, hi, hi'
    calls = []

    def agree(t):
        calls.append(t)
        return next(agreed)

    steps = []

    def step(v):
        steps.append(1)
        return v * 1.0

    ms = loop_ms_per_iter(step, torch.ones(8), k_lo=2, k_hi=6, repeats=1,
                          agree=agree)
    assert len(calls) == 4
    k_next = 2 + int(0.4 / (0.001 / 4)) + 1       # re-aimed at 0.4 s
    assert ms == pytest.approx((0.090 - 0.010) / (k_next - 2) * 1e3)
    # Each timed count runs twice (a warm-up and one repeat).
    assert len(steps) == 2 * (2 + 6 + k_next)


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """One ``bench_torch.py --smoke --device cpu`` run, tracing on."""
    trace = tmp_path_factory.mktemp("bench_torch") / "smoke.trace.json"
    env = dict(os.environ, LEGATE_SPARSE_TPU_OBS="1",
               LEGATE_SPARSE_TPU_OBS_FILE=str(trace),
               PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "bench_torch.py", "--smoke",
                        "--device", "cpu"], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert sum(ln.startswith("{") for ln in lines) == 1
    return json.loads(lines[-1]), trace


def test_smoke_has_every_headline_field(smoke_run):
    result, _ = smoke_run
    for key in bench_torch.HEADLINE_NUMBERS:
        assert key in result, key
        if key in ("vs_baseline", "mem_device_peak_mb"):
            assert result[key] is None      # no device metric on the CPU
        else:
            assert np.isfinite(result[key]), key
    for key in bench_torch.HEADLINE_STRINGS:
        assert isinstance(result[key], str), key
    assert result["cpu_vs_baseline"] > 0
    assert result["smoke"] is True
    assert len(result["stream_samples"]) == 5
    assert result["cg_ms_per_iter_min"] <= result["cg_ms_per_iter"] \
        <= result["cg_ms_per_iter_max"]


def test_smoke_trace_has_spans(smoke_run):
    result, trace = smoke_run
    assert result["trace_file"] == str(trace) and result["trace_spans"] > 0
    doc = json.loads(trace.read_text())
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert {"bench.spmv", "bench.cg", "bench.spgemm"} <= names
    assert {f"bench.{p}" for p in bench_torch.PHASE_NUMBERS} <= names
    # The distributed phases' spans are rank 0's.
    ranked = {ev["name"] for ev in doc["traceEvents"]
              if (ev.get("args") or {}).get("rank") == 0}
    assert {"bench.dist", "bench.dist2d", "bench.recovery", "bench.graph",
            "bench.attrib", "bench.placement"} <= ranked


def test_smoke_deterministic_fields_match_the_api(smoke_run):
    """The fields that do not depend on a clock, recomputed through the
    port's API at the smoke sizes."""
    result, _ = smoke_run
    S = bench_torch.SMOKE
    n = 1 << S["log2_rows"]
    offsets = list(range(-5, 6))
    A = tsparse.diags([np.full(n - abs(o), np.float32(1 / 11))
                       for o in offsets], offsets, shape=(n, n),
                      format="csr", dtype=torch.float32, device="cpu")
    x = torch.ones(n)
    A @ x
    assert A.spmv_path == "dia-kernel" and A._get_dia() is not None
    assert result["path"] == "dia"
    assert result["spmv_bytes_per_nnz"] == round(
        A.spmv_traffic_bytes(x, path=A.spmv_path) / A.nnz, 4)
    assert result["spgemm_n"] == S["spgemm_rows"]
    g = S["pde_grid"]
    P = bench_torch._poisson_f32(g, "cpu")
    xp = torch.ones(g * g)
    P @ xp
    assert result["pde_bytes_per_iter"] == (
        P.spmv_traffic_bytes(xp, path=P.spmv_path) + 4 * g * g)
    assert (result["cg_grid"], result["gmg_grid"], result["pde_grid"]) == (
        f"{S['cg_grid']}x{S['cg_grid']}", f"{S['gmg_grid']}x{S['gmg_grid']}",
        f"{g}x{g}")
    assert result["cg_1m_rows"] == S["cg_1m_grid"] ** 2
    assert result["platform"] == "cpu"


def test_smoke_has_every_phase_field(smoke_run):
    """Every field of the twelve phases, on 8 ranks: numbers finite,
    the strings strings, ``schema_version`` bench.py's 20."""
    result, _ = smoke_run
    assert result["schema_version"] == 20
    for phase, keys in bench_torch.PHASE_NUMBERS.items():
        for key in keys:
            val = result.get(key)
            assert isinstance(val, (int, float)) and np.isfinite(val), (
                phase, key, val)
    for key in bench_torch.PHASE_STRINGS:
        assert isinstance(result[key], str), key
    assert [lv["clients"] for lv in result["saturation"]] == [1, 2, 4, 8]
    assert set(result["rank_phase_s"]) == {
        "dist", "dist2d", "recovery", "graph", "attrib", "placement"}
    # The CPU launches no kernel.
    launches = result["rank_kernel_launches"]
    assert set(launches) == {"gmg"} | set(result["rank_phase_s"])
    for counts in launches.values():
        assert counts == dict.fromkeys(kernel_wrappers(), 0)


@pytest.mark.parametrize("name", [k for k in GATED if k not in DIVERGENT])
def test_smoke_field_equals_golden(smoke_run, name):
    """The JAX golden's value, through the port's ``regress.compare``:
    equal, or within 1% for ``*_comm_bytes``."""
    result, _ = smoke_run
    found = [f for f in regress.compare(GOLDEN, result, fields=[name])
             if f["field"] == name]
    assert len(found) == 1, found
    f = found[0]
    assert f["status"] == "ok" or (
        f["status"] == "improved" and f["kind"] == "comm"
        and f["worse_by"] >= 1 - regress.COMM_TOL), f


@pytest.mark.parametrize("name", sorted(DIVERGENT))
def test_smoke_divergent_field(smoke_run, name):
    """A field that differs from the golden by design (the queue-3 item
    in ``DIVERGENT``) still differs, and equals the port's own value."""
    result, _ = smoke_run
    _item, port_value = DIVERGENT[name]
    assert result[name] != GOLDEN[name], (
        f"{name} now equals the JAX golden: drop it from DIVERGENT")
    assert result[name] == port_value
    if name.startswith("dist2d_spgemm"):
        # The 2-d SUMMA still sends fewer bytes than the 1-d product.
        assert 0 < result["dist2d_spgemm_comm_bytes"] \
            < result["dist2d_spgemm_1d_comm_bytes"]
    else:
        assert result[name] > 0


def test_no_gpu_no_fallback():
    """Without ``--device cpu`` the bench runs on ``cuda`` or raises: no
    result line, a non-zero exit."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the bench would run on it")
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=str(ROOT),
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())


def test_a_failing_phase_ends_the_run(monkeypatch, capsys):
    """A phase that raises is not caught: ``main`` raises and prints no
    result; so does a distributed phase that raises on the ranks (a
    size the dist phase cannot use, which every rank receives)."""
    def boom(*a, **k):
        raise ValueError("banded config failed")

    threads = torch.get_num_threads()
    try:
        with monkeypatch.context() as m:
            m.setattr(bench_torch, "_banded_config", boom)
            with pytest.raises(ValueError, match="banded config failed"):
                bench_torch.main(["--smoke", "--device", "cpu"])
        monkeypatch.setattr(bench_torch, "SMOKE", dict(
            bench_torch.SMOKE, dist_log2_rows="twelve"))
        with pytest.raises(RuntimeError, match=r"rank \d raised") as e:
            bench_torch.main(["--smoke", "--device", "cpu"])
        assert "_dist_phase" in str(e.value) and "TypeError" in str(e.value)
    finally:
        runtime.set_device(None)
        torch.set_num_threads(threads)
    assert not any(ln.startswith("{")
                   for ln in capsys.readouterr().out.splitlines())
