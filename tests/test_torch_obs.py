# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's observability core (``legate_sparse_tpu_torch.obs``):
spans and events, counters, latency histograms, the Chrome/JSONL and
OpenMetrics exports, memory watermarks and the comm ledger, and their
wiring into ``dot``, SpGEMM, the solvers, the scipy fallbacks and the
kernel wrappers — each against the JAX package's ``obs`` on the CPU.

Mirrors the framework-free cases of ``test_obs.py``.  Cross-package
parity: the same direct calls give equal ``op.*``, ``transfer.host_sync.*``,
``scipy_fallback.*`` and ``build.csr.coo.*`` counters and equal ``lat.*``
histogram counts, except where the port differs by design (ROADMAP
queue 3 item 11): ``op.spmv`` inside a solver (the JAX package counts
a jit trace, the port every SpMV that runs) and ``cg_conv`` (the JAX
package's one-shot CG loop makes no fetch to count).  Equal counters
and histograms render the same OpenMetrics text, and every ``comm``
formula gives the JAX package's value.
"""

import json
import re
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import legate_sparse_tpu as jsparse
import legate_sparse_tpu.linalg as jlinalg
from legate_sparse_tpu import obs as jobs

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch import obs
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.obs import comm, counters, export, latency, memory
from legate_sparse_tpu_torch.obs import trace
from legate_sparse_tpu_torch.settings import settings

PARITY_PREFIXES = ("op.", "transfer.host_sync.", "scipy_fallback.",
                   "build.csr.coo.")


@pytest.fixture(autouse=True)
def _isolation():
    """Each test starts with tracing off and empty buffers in both
    packages, on the CPU, and leaves nothing behind."""
    runtime.set_device("cpu")
    obs.reset_all()
    jobs.reset_all()
    trace.disable()
    jobs.trace.disable()
    yield
    trace.disable()
    jobs.trace.disable()
    obs.reset_all()
    jobs.reset_all()
    runtime.set_device(None)


def banded(n=32, dtype=np.float32):
    return sp.diags([np.ones(n - 1), np.full(n, 4.0), np.ones(n - 1)],
                    [-1, 0, 1], shape=(n, n), format="csr").astype(dtype)


def pair(S):
    return jsparse.csr_array(S), tsparse.csr_array(S, device="cpu")


def irregular(n=300, seed=0):
    rng = np.random.default_rng(seed)
    S = sp.random(n, n, density=0.03, random_state=rng, format="csr",
                  dtype=np.float64)
    return (S + sp.eye(n)).tocsr().astype(np.float32)


# ---------------------------------------------------------------- trace


def test_disabled_mode_records_nothing():
    assert not trace.enabled()
    with obs.span("never", nnz=1) as sp_:
        assert sp_ is None
    obs.event("never.event", detail=1)
    assert obs.records() == []


def test_disabled_span_is_shared_singleton():
    assert trace.span("x", k=1) is trace.span("y") is trace._NULL_SPAN


def test_spans_nest_and_record_depth_and_sequence():
    trace.enable()
    with obs.span("outer"):
        with obs.span("inner"):
            with obs.span("innermost"):
                pass
        with obs.span("inner"):
            pass
    recs = obs.records()
    assert [r["name"] for r in recs] == ["innermost", "inner", "inner",
                                         "outer"]
    assert [r["depth"] for r in recs] == [2, 1, 1, 0]
    assert [r["seq"] for r in recs if r["name"] == "inner"] == [0, 1]
    assert [r["first"] for r in recs if r["name"] == "inner"] == [True,
                                                                  False]
    assert recs[-1]["dur_ns"] >= recs[1]["dur_ns"]


def test_span_set_attaches_late_attrs_and_errors_are_recorded():
    trace.enable()
    with obs.span("op", early=1) as sp_:
        sp_.set(late="kernel-choice")
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("x")
    recs = obs.records()
    assert recs[0]["attrs"] == {"early": 1, "late": "kernel-choice"}
    assert recs[1]["attrs"]["error"] == "ValueError"


def test_events_and_complete_spans():
    trace.enable()
    obs.event("probe.fail", attempt=1, rc=2)
    obs.complete_span("request", 100, 50, rid=7)
    ev, sp_ = obs.records()
    assert ev["type"] == "event" and "dur_ns" not in ev
    assert ev["attrs"] == {"attempt": 1, "rc": 2}
    assert sp_["type"] == "span" and sp_["dur_ns"] == 50 and sp_["first"]


def test_span_attrs_accumulate_into_counters():
    trace.enable()
    with obs.span("op", nnz=10, bytes=100):
        pass
    with obs.span("op", nnz=5, bytes=50, flops=7):
        pass
    assert counters.get("obs.nnz_processed") == 15
    assert counters.get("obs.bytes_moved") == 150
    assert counters.get("obs.flops") == 7


def test_buffer_cap_drops_and_counts(monkeypatch):
    trace.enable()
    monkeypatch.setattr(trace, "MAX_RECORDS", 2)
    for _ in range(4):
        with obs.span("op"):
            pass
    assert len(obs.records()) == 2
    assert counters.get("obs.dropped_records") == 2


def test_settings_obs_property_delegates():
    assert settings.obs is False
    settings.obs = True
    try:
        assert trace.enabled()
    finally:
        settings.obs = False
    assert not trace.enabled()


# ------------------------------------------------------------- counters


def test_counters_accumulate_and_reset():
    counters.inc("a.x")
    counters.inc("a.x", 2)
    counters.inc("a.y", 1.5)
    counters.handle("b.z").inc()
    assert counters.get("a.x") == 3
    assert counters.snapshot("a.") == {"a.x": 3, "a.y": 1.5}
    counters.reset("a.")
    assert counters.get("a.x") == 0 and counters.get("b.z") == 1
    counters.reset()
    assert counters.snapshot() == {}


def test_handles_lose_no_increment_across_threads():
    """Eight threads on buffered handles and the locked path at once,
    with resets of another prefix in between: every increment counts."""
    n_threads, per = 8, 2000

    def work():
        h = counters.handle("stress.h")
        for i in range(per):
            h.inc()
            counters.inc("stress.l")
            if i % 500 == 0:
                counters.reset("other.")

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert counters.get("stress.h") == n_threads * per
    assert counters.get("stress.l") == n_threads * per


def test_counters_live_even_when_tracing_disabled():
    _, A = pair(banded())
    A @ torch.ones(A.shape[0])
    assert counters.get("op.spmv") == 1
    assert obs.records() == []


# -------------------------------------------------------------- exports


def test_chrome_trace_export_is_valid_json(tmp_path):
    trace.enable()
    with obs.span("spmv", nnz=11, bytes=88):
        pass
    obs.event("probe.fail", rc=1)
    latency.observe("lat.demo.n32", 1.5)
    path = tmp_path / "out.trace.json"
    assert obs.write_chrome_trace(str(path), extra_metadata={"tag": "t"}) == 2
    doc = json.loads(path.read_text())
    x = [e for e in doc["traceEvents"] if e["ph"] == "X"][0]
    assert x["name"] == "spmv" and x["dur"] >= 0
    assert x["args"]["nnz"] == 11 and x["args"]["first_call"] is True
    i = [e for e in doc["traceEvents"] if e["ph"] == "i"][0]
    assert i["name"] == "probe.fail"
    meta = doc["otherData"]
    assert meta["tag"] == "t" and meta["counters"]["obs.nnz_processed"] == 11
    assert meta["histograms"]["lat.demo.n32"]["count"] == 1


def test_jsonl_export_roundtrip(tmp_path):
    trace.enable()
    with obs.span("op", nnz=3, dt=np.float32(2.0)):
        pass
    path = tmp_path / "out.jsonl"
    assert obs.write_jsonl(str(path)) == 1
    (rec,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert rec["name"] == "op" and rec["attrs"] == {"nnz": 3, "dt": 2.0}


# ---------------------------------------------------------------- wiring


def test_spmv_spmm_span_attrs():
    trace.enable()
    _, A = pair(banded())
    x = torch.ones(A.shape[0])
    A @ x
    A @ x
    A @ torch.ones(A.shape[0], 3)
    spans = [r for r in obs.records() if r["name"] == "spmv"]
    assert len(spans) == 2 and spans[0]["first"] and not spans[1]["first"]
    at = spans[0]["attrs"]
    assert at["path"] == "dia-kernel" and at["nnz"] == A.nnz
    assert at["rows"] == 32 and at["flops"] == 2 * A.nnz
    # 3 diagonals of 32 f32, x and y, no hole mask.
    assert at["bytes"] == 3 * 32 * 4 + 2 * 32 * 4
    (mm,) = [r for r in obs.records() if r["name"] == "spmm"]
    assert mm["attrs"]["k"] == 3 and mm["attrs"]["path"] == "dia-kernel"
    kernels = [r["name"] for r in obs.records()
               if r["name"].startswith("kernel.")]
    assert kernels == ["kernel.dia_spmv", "kernel.dia_spmv",
                       "kernel.dia_spmm"]


def test_spgemm_span_records_output_nnz():
    trace.enable()
    _, A = pair(banded())
    C = A @ A
    (sp_,) = [r for r in obs.records() if r["name"] == "spgemm"]
    assert sp_["attrs"]["nnz"] == C.nnz
    assert sp_["attrs"]["path"] == "dia-kernel"
    _, R = pair(irregular(60))
    C = R @ R
    esc = [r for r in obs.records() if r["name"] == "spgemm"][-1]
    assert esc["attrs"]["path"] == "esc" and esc["attrs"]["nnz"] == C.nnz


def test_solver_spans_record_iterations():
    trace.enable()
    _, A = pair(banded(64))
    b = torch.ones(64)
    _, iters = tlinalg.cg(A, b, rtol=1e-6, maxiter=100)
    (sp_,) = [r for r in obs.records() if r["name"] == "cg"]
    assert sp_["attrs"]["iters"] == iters > 0 and sp_["attrs"]["n"] == 64
    assert sp_["attrs"]["nnz"] == A.nnz * iters
    tlinalg.gmres(A, b, restart=5, rtol=1e-6)
    assert [r for r in obs.records() if r["name"] == "gmres.cycle"]
    tlinalg.bicgstab(A, b, rtol=1e-6)
    assert [r for r in obs.records() if r["name"] == "bicgstab"]
    tlinalg.cg(A, b, rtol=1e-6, refine="auto")
    (rf,) = [r for r in obs.records() if r["name"] == "cg.refine"]
    assert rf["attrs"]["inner_dtype"] == "bfloat16"
    assert rf["attrs"]["iters"] > 0


def test_scipy_fallback_counter_and_span():
    trace.enable()
    _, A = pair(banded(16, np.float64))
    tlinalg.spsolve(A, torch.ones(16, dtype=torch.float64))
    assert counters.get("scipy_fallback.linalg.spsolve") == 1
    (sp_,) = [r for r in obs.records() if r["name"] == "scipy_fallback"]
    assert sp_["attrs"]["func"] == "linalg.spsolve"


def test_coo_build_counter():
    tsparse.csr_array((np.ones(3), ([0, 1, 4], [2, 0, 1])), shape=(5, 3),
                      device="cpu")
    assert counters.snapshot("build.") == {"build.csr.coo.8x4": 1}


# --------------------------------------------------------------- latency


def test_dot_records_latency_histogram_per_shape_bucket():
    _, A = pair(banded(48))
    x = torch.ones(48)
    for _ in range(5):
        A @ x
    hist = latency.get("lat.spmv.n64")
    assert hist is not None and hist.count == 5 and hist.quantile(0.5) > 0
    A @ torch.ones(48, 3)
    assert latency.get("lat.spmm.n64").count == 1


def test_latency_histograms_add_no_sync_counter():
    """Steady-state dots with tracing on move the histograms and leave
    every ``transfer.*`` counter alone: recording is host arithmetic."""
    trace.enable()
    _, A = pair(banded(64))
    x = torch.ones(64)
    A @ x
    before = counters.snapshot("transfer.")
    for _ in range(10):
        A @ x
    assert counters.snapshot("transfer.") == before
    assert latency.get("lat.spmv.n64").count == 11


def test_solver_latency_histograms_recorded():
    _, A = pair(banded(96))
    b = torch.ones(96)
    tlinalg.cg(A, b, maxiter=10)
    assert latency.get("lat.cg.solve.n128").count == 1
    tlinalg.gmres(A, b, restart=5, maxiter=10)
    assert latency.get("lat.gmres.cycle.n128").count >= 1


def test_histogram_quantile_error_bound():
    rng = np.random.default_rng(0)
    vals = np.exp(rng.uniform(-8, 8, 4000))
    for v in vals:
        latency.observe("lat.fuzz", float(v))
    h = latency.get("lat.fuzz")
    assert h.count == 4000 and h.sum == pytest.approx(vals.sum())
    srt = np.sort(vals)
    for q in (0.01, 0.5, 0.9, 0.99):
        exact = srt[max(1, int(np.ceil(q * len(srt)))) - 1]
        assert abs(h.quantile(q) - exact) <= latency.REL_ERR * exact * 1.0001
    back = latency.Histogram.from_dict("lat.fuzz", h.to_dict())
    assert back.counts == h.counts


# ------------------------------------------------------------ OpenMetrics


def test_openmetrics_snapshot_parses_minimal_format():
    counters.inc("omt.calls", 3)
    for v in (0.5, 1.5, 1.5, 200.0, 0.0):
        latency.observe("lat.omt.demo", v)
    text = obs.snapshot_openmetrics()
    assert text.endswith("# EOF\n")
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                        r'(?:\{([a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
                        r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*)\})? (\S+)$')
    for line in text.splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (TYPE|HELP|EOF)", line), line
        else:
            assert sample.match(line), line
    cnts, hists = export.parse_openmetrics(text)
    assert cnts["omt.calls"] == 3
    h = hists["lat.omt.demo"]
    assert h["count"] == 5 and h["sum"] == pytest.approx(203.5)
    les = [le for le, _ in h["buckets"]]
    assert les[-1] == float("inf") and les == sorted(les)
    assert [c for _, c in h["buckets"]][-1] == 5
    with pytest.raises(ValueError):
        export.parse_openmetrics("garbage 1\n# EOF\n")
    with pytest.raises(ValueError):
        export.parse_openmetrics("")


def test_write_openmetrics_to_file_and_env(tmp_path, monkeypatch):
    counters.inc("omt.file", 1)
    p = tmp_path / "metrics.prom"
    assert export.write_openmetrics(str(p)) == str(p)
    assert 'name="omt.file"' in p.read_text()
    monkeypatch.setenv(export.ENV_PROM_FILE, str(tmp_path / "e.prom"))
    export.write_openmetrics()
    assert (tmp_path / "e.prom").read_text().endswith("# EOF\n")
    monkeypatch.delenv(export.ENV_PROM_FILE)
    with pytest.raises(ValueError):
        export.write_openmetrics()


# ----------------------------------------------------------------- memory


def test_memory_snapshot_and_watermark():
    snap = memory.snapshot()
    assert snap["rss_mb"] > 0 and snap["peak_rss_mb"] >= snap["rss_mb"]
    # No CUDA device: no device keys, as the JAX package emits none
    # where its backend is silent.
    if not torch.cuda.is_available():
        assert "device_mb" not in snap and "device_peak_mb" not in snap
    with memory.watermark("phase"):
        pass
    assert obs.records() == []          # off while tracing is off
    trace.enable()
    with memory.watermark("phase", predicted=4) as wm:
        wm.set(nnz=9)
    (ev,) = obs.records()
    assert ev["name"] == "mem.phase"
    assert ev["attrs"]["predicted"] == 4 and ev["attrs"]["nnz"] == 9
    assert "rss_mb_before" in ev["attrs"] and "rss_delta_mb" in ev["attrs"]


# ------------------------------------------------ cross-package parity


def _parity_snapshot(pkg_obs):
    snap = pkg_obs.counters.snapshot()
    return {k: v for k, v in snap.items() if k.startswith(PARITY_PREFIXES)}


def _hist_counts(pkg_obs):
    """Counts of the histograms observed since the last reset (a reset
    keeps a histogram's name at count 0)."""
    return {k: h.count for k, h in pkg_obs.latency.snapshot("lat.").items()
            if h.count}


def test_direct_calls_give_equal_counters_and_histogram_counts():
    for pkg_obs in (obs, jobs):
        pkg_obs.reset_all()
    Sb, Si = banded(64), irregular(120)
    (Bj, Bt), (Ij, It) = pair(Sb), pair(Si)
    x = np.linspace(-1.0, 1.0, 64).astype(np.float32)
    X = np.ones((120, 3), np.float32)
    for A, xv, XV in ((Bt, torch.from_numpy(x), torch.from_numpy(X)),
                      (Bj, jnp.asarray(x), jnp.asarray(X))):
        A @ xv
        A @ xv
    It @ torch.from_numpy(X)
    Ij @ jnp.asarray(X)
    Bt @ Bt
    Bj @ Bj
    It @ It
    Ij @ Ij
    coo = (np.ones(4, np.float32), ([0, 3, 3, 9], [1, 2, 2, 0]))
    tsparse.csr_array(coo, shape=(10, 4), device="cpu")
    jsparse.csr_array(coo, shape=(10, 4))
    tlinalg.spsolve(Bt.astype(torch.float64),
                    torch.ones(64, dtype=torch.float64))
    jlinalg.spsolve(Bj.astype(np.float64), np.ones(64))
    snap = _parity_snapshot(obs)
    assert snap == _parity_snapshot(jobs)
    assert snap["op.spmv"] == 2 and snap["op.spgemm"] == 2
    assert snap["transfer.host_sync.spgemm_T"] == 1
    assert _hist_counts(obs) == _hist_counts(jobs)


def test_solver_calls_give_equal_solver_counters():
    """Solver-level names agree; ``op.spmv`` inside a solve and the
    ``cg_conv`` fetches are the divergences by design."""
    for pkg_obs in (obs, jobs):
        pkg_obs.reset_all()
    S = banded(64, np.float64)
    Aj, At = pair(S)
    b = np.linspace(0.5, 1.5, 64)
    for lin, A, bv in ((tlinalg, At, torch.from_numpy(b)),
                       (jlinalg, Aj, jnp.asarray(b))):
        lin.cg(A, bv, rtol=1e-8)
        lin.gmres(A, bv, restart=6, rtol=1e-8)
        lin.bicgstab(A, bv, rtol=1e-8)
        lin.gmres(A, bv, restart=6, rtol=1e-8, refine="auto")

    def solver_level(pkg_obs):
        return {k: v for k, v in _parity_snapshot(pkg_obs).items()
                if k not in ("op.spmv", "op.spmm",
                             "transfer.host_sync.cg_conv")}

    assert solver_level(obs) == solver_level(jobs)
    # Two direct calls, and one inner solve for every refinement cycle
    # but the last, which converged.
    assert (counters.get("op.gmres")
            == 1 + counters.get("transfer.host_sync.gmres_refine"))
    assert counters.get("transfer.host_sync.cg_conv") >= 1
    assert jobs.counters.get("transfer.host_sync.cg_conv") == 0

    def solver_hists(pkg_obs):
        return {k: v for k, v in _hist_counts(pkg_obs).items()
                if not k.startswith(("lat.spmv.", "lat.spmm."))}

    assert solver_hists(obs) == solver_hists(jobs)


def test_render_openmetrics_same_text_as_jax():
    snap = {"op.spmv": 42, "transfer.host_sync.gmres_conv": 3,
            "obs.bytes_moved": 1.5e9, "weird \"name\"\n": 0.25}
    vals = (0.0, 1e-6, 0.03, 0.5, 1.5, 1.5, 200.0, 3.7e5)
    for v in vals:
        latency.observe("lat.spmv.n4096", v)
        jobs.latency.observe("lat.spmv.n4096", v)
    name = "lat.spmv.n4096"
    text = export.render_openmetrics(snap, {name: latency.get(name)})
    assert text == jobs.export.render_openmetrics(
        snap, {name: jobs.latency.get(name)})
    back, hists = export.parse_openmetrics(text)
    assert back == snap
    assert hists["lat.spmv.n4096"]["count"] == len(vals)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_comm_formulas_match_jax(shards):
    jc = jobs.comm
    for elems in (0, 1, 7, 4096):
        for item in (2, 4, 8):
            for name in ("all_gather_bytes", "psum_bytes",
                         "all_to_all_bytes", "reduce_scatter_bytes",
                         "halo_exchange_bytes"):
                assert (getattr(comm, name)(elems, item, shards)
                        == getattr(jc, name)(elems, item, shards))
            for rounds in (1, 3):
                assert (comm.ppermute_bytes(elems, item, shards, rounds)
                        == jc.ppermute_bytes(elems, item, shards, rounds))
            for kind, kw in (("collective_permute", {"moved_pairs": 3}),
                             ("all_gather", {"group_sizes": (shards, 2)}),
                             ("all_reduce", {"group_sizes": (shards,)}),
                             ("reduce_scatter", {"group_sizes": (shards,)}),
                             ("all_to_all", {"group_sizes": (shards, 1)})):
                assert (comm.lowered_op_bytes(kind, elems * item, **kw)
                        == jc.lowered_op_bytes(kind, elems * item, **kw))
            sv = dict(shards=shards, x_local_elems=elems, itemsize=item)
            for halo, precise in ((-1, None), (0, None), (5, None),
                                  (-1, 6)):
                for cols in (1, 4):
                    got = comm.spmv_volumes(halo=halo, precise_C=precise,
                                            cols=cols, **sv)
                    assert got == jc.spmv_volumes(halo=halo,
                                                  precise_C=precise,
                                                  cols=cols, **sv)
                    assert (comm.cg_iteration_volumes(got, item, shards)
                            == jc.cg_iteration_volumes(got, item, shards))
                    for restart in (1, 20):
                        assert (comm.gmres_cycle_volumes(got, restart, item,
                                                         shards)
                                == jc.gmres_cycle_volumes(got, restart, item,
                                                          shards))
            assert (comm.reshard_volumes(moved_chunks=shards - 1,
                                         chunk_elems=elems, itemsize=item,
                                         shards=shards)
                    == jc.reshard_volumes(moved_chunks=shards - 1,
                                          chunk_elems=elems, itemsize=item,
                                          shards=shards))
    for rows, cols in ((1, shards), (shards, 1), (2, 4), (4, 2)):
        assert (comm.transpose_moved_chunks(rows, cols)
                == jc.transpose_moved_chunks(rows, cols))
        kw = dict(grid_rows=rows, grid_cols=cols, spc=5, rps=7, itemsize=4)
        assert comm.spmv_volumes_2d(**kw) == jc.spmv_volumes_2d(**kw)
        kw = dict(grid_rows=rows, grid_cols=cols, spc=5, rps=7, x_itemsize=1,
                  y_itemsize=4, collective="pmin")
        assert (comm.spmv_volumes_2d_semiring(**kw)
                == jc.spmv_volumes_2d_semiring(**kw))


def test_comm_record_counters():
    vols = comm.spmv_volumes(shards=4, halo=-1, precise_C=None,
                             x_local_elems=100, itemsize=4)
    total = comm.record("dist_spmv", comm.merge(vols, {"psum": 0}),
                        calls={"all_gather": 2})
    assert total == 4 * 3 * 100 * 4
    snap = counters.snapshot("comm.")
    assert snap["comm.dist_spmv.all_gather"] == 2
    assert snap["comm.dist_spmv.all_gather_bytes"] == total
    assert snap["comm.total_bytes"] == total
    assert snap["comm.layout.1d-row.dist_spmv_bytes"] == total
    assert "comm.dist_spmv.psum" not in snap
    assert comm.scale(vols, 3) == {"all_gather": 3 * total}
    assert comm.total(vols) == total
