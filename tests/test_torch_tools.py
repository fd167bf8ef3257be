# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's tools (``legate_sparse_tpu_torch/tools``) against the
repo's JAX-bound ones, imported in-process (``utils_test.tools``).

- ``bench_compare``: the same stdout and exit code as
  ``tools/bench_compare.py`` on the archived round pair, the trajectory
  over the repo root, a ``--fields`` restriction, a regressed copy (1),
  an unreadable file and a missing argument (2).
- ``trace_summary``: the same stdout and exit code as
  ``tools/trace_summary.py`` for every flag, on a Chrome trace and a
  newline-JSON file the port's ``obs`` wrote and a Chrome trace the JAX
  package's wrote, each from a small seeded run, and on a file with no
  span (2).
- ``tune_irregular --smoke --device cpu``: per config, rows, nnz,
  density, fingerprint class, ``nblocks``, ``nnz_per_block`` and the
  verdict key less its platform term equal the JAX package's on the
  same numpy COO (the JAX tool's arithmetic, replayed from the port's
  ``configs``); every raced candidate's ``A @ x`` within 1e-5 (f32,
  relative to the largest entry) of the JAX package's.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse
from legate_sparse_tpu import autotune as jautotune
from legate_sparse_tpu import obs as jobs
from legate_sparse_tpu.ops import bsr as jbsr
from legate_sparse_tpu.settings import settings as jsettings

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import autotune as tautotune
from legate_sparse_tpu_torch import engine as tengine
from legate_sparse_tpu_torch import obs as tobs
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.settings import settings as tsettings
from legate_sparse_tpu_torch.tools import bench_compare as tbench_compare
from legate_sparse_tpu_torch.tools import trace_summary as ttrace_summary
from legate_sparse_tpu_torch.tools import tune_irregular
from utils_test.tools import load_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KNOBS = ("autotune", "gateway")


@pytest.fixture(autouse=True)
def _isolation():
    saved = [{k: getattr(s, k) for k in _KNOBS}
             for s in (jsettings, tsettings)]
    yield
    for s, vals in zip((jsettings, tsettings), saved):
        for k, v in vals.items():
            setattr(s, k, v)
    runtime.set_device(None)


def _run(main, argv):
    """(rc, stdout) of a tool's ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, out.getvalue()


def _same(tool_name, port_main, argv):
    want = _run(load_tool(tool_name).main, argv)
    got = _run(port_main, argv)
    assert got == want
    return got


# ---- bench_compare ---------------------------------------------------
@pytest.fixture(scope="module")
def bench_files(tmp_path_factory):
    from legate_sparse_tpu_torch.obs import regress

    d = tmp_path_factory.mktemp("bench")
    new = regress.load_bench(os.path.join(REPO, "BENCH_r05.json"))
    worse = dict(new, **{k: v * 10 for k, v in new.items()
                         if k.endswith("_ms") and isinstance(v, float)})
    (d / "regressed.json").write_text(json.dumps(worse))
    (d / "garbage.json").write_text("no json here")
    return d


@pytest.mark.parametrize("case", ["pair", "trajectory", "fields",
                                  "regressed", "unreadable", "usage"])
def test_bench_compare_equals_the_tool(case, bench_files):
    r04 = os.path.join(REPO, "BENCH_r04.json")
    r05 = os.path.join(REPO, "BENCH_r05.json")
    argv, rc = {
        "pair": ([r04, r05], 0),
        "trajectory": (["--trajectory", "--dir", REPO], 0),
        "fields": ([r04, r05, "--fields", "*_comm_bytes"], 0),
        "regressed": ([r05, str(bench_files / "regressed.json")], 1),
        "unreadable": ([r05, str(bench_files / "garbage.json")], 2),
        "usage": ([r05], 2),
    }[case]
    got_rc, text = _same("bench_compare", tbench_compare.main, argv)
    assert got_rc == rc
    assert (text != "") == (rc != 2)


# ---- trace_summary ---------------------------------------------------
def _seeded(seed=4):
    rng = np.random.default_rng(seed)
    S = sp.random(300, 300, density=0.02, format="csr", random_state=rng)
    S = (S + sp.eye(300)).tocsr()
    return S, rng.standard_normal(300)


def _port_trace(path, jsonl_path):
    """A small seeded run through the port with tracing on: products,
    an event, a tuned and a routed dispatch, a gateway load and a comm
    ledger entry; written in both export formats."""
    runtime.set_device("cpu")
    tobs.reset_all()
    tautotune.reset()
    # A module fixture runs this before ``_isolation`` saves the knobs:
    # restore them here.
    saved = {k: getattr(tsettings, k) for k in _KNOBS}
    tobs.enable()
    try:
        S, x = _seeded()
        A = tsparse.csr_array(S, device="cpu")
        xt = torch.as_tensor(x)
        for _ in range(3):
            A @ xt
        tobs.event("probe.declined", reason="seeded", n=3)
        tsettings.autotune = True
        tautotune.tune(A, xt)
        A @ xt
        tsettings.autotune = False
        tsettings.gateway = True
        gw = tengine.Gateway(tengine.Engine())
        try:
            for i, qos in enumerate(("interactive", "batch", "background")):
                gw.submit(A, xt, tenant=f"t{i}", qos=qos).result()
        finally:
            gw.shutdown()
        tobs.comm.record("dist_spmv", tobs.comm.spmv_volumes(
            shards=4, halo=8, precise_C=None, x_local_elems=75,
            itemsize=8))
        tobs.write_chrome_trace(str(path), extra_metadata={
            "platform": "cpu", "bench_result": {"stream_gbs": 12.5}})
        tobs.write_jsonl(str(jsonl_path))
    finally:
        tobs.disable()
        tobs.reset_all()
        for k, v in saved.items():
            setattr(tsettings, k, v)
        runtime.set_device(None)


def _jax_trace(path):
    """The same products and event through the JAX package."""
    import jax.numpy as jnp

    jobs.reset_all()
    jobs.enable()
    try:
        S, x = _seeded()
        A = jsparse.csr_array(S)
        for _ in range(3):
            A @ jnp.asarray(x)
        jobs.event("probe.declined", reason="seeded", n=3)
        jobs.write_chrome_trace(str(path))
    finally:
        jobs.disable()
        jobs.reset_all()


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    _port_trace(d / "port.trace.json", d / "port.jsonl")
    _jax_trace(d / "jax.trace.json")
    (d / "nospan.jsonl").write_text(json.dumps(
        {"type": "event", "name": "x", "ts_ns": 0}) + "\n")
    runtime.set_device(None)
    return d


FLAGS = ["", "--events", "--counters", "--comm", "--plans", "--resil",
         "--gateway", "--autotune", "--flows", "--slo", "--graph",
         "--tenants", "--placement", "--delta", "--latency",
         "--stream-gbs=819"]


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("trace", ["port.trace.json", "port.jsonl",
                                   "jax.trace.json"])
def test_trace_summary_equals_the_tool(trace, flag, traces):
    argv = [str(traces / trace)] + ([flag] if flag else [])
    rc, text = _same("trace_summary", ttrace_summary.main, argv)
    assert rc == 0 and text.startswith("op ")


def test_trace_summary_port_trace_tables(traces):
    """The port's trace fills the tables the phase reads."""
    rc, text = _run(ttrace_summary.main, [
        str(traces / "port.trace.json"), "--comm", "--autotune",
        "--gateway", "--latency"])
    assert rc == 0
    assert "dist_spmv" in text and "autotune.verdict.records" in text
    assert "interactive" in text and "lat.spmv" in text
    assert "vs_stream" in text


def test_trace_summary_no_span(traces):
    rc, text = _same("trace_summary", ttrace_summary.main,
                     [str(traces / "nospan.jsonl")])
    assert rc == 2 and text == ""


# ---- tune_irregular --------------------------------------------------
@pytest.fixture(scope="module")
def shootout():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tune_irregular.main(["--smoke", "--device", "cpu"])
    runtime.set_device(None)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    return res


def _jax_config(spec):
    """The JAX package's matrix of a config spec, its duplicates summed
    by scipy on the host (ones, or the power-law draws: the sums the
    JAX package's ``sum_duplicates`` gives, without its compiles)."""
    if spec[0] == "powerlaw":
        J = jsparse.gallery.powerlaw(
            spec[1], nnz_per_row=tune_irregular.POWERLAW_NNZ_PER_ROW,
            rng=tune_irregular.POWERLAW_SEED, dtype=np.float32)
        S = sp.csr_matrix((np.array(J.data), np.array(J.indices),
                           np.array(J.indptr)), shape=J.shape)
    else:
        _, r, c, n = spec
        S = sp.csr_matrix((np.ones(r.shape[0], np.float32), (r, c)),
                          shape=(n, n))
    S.sum_duplicates()
    return jsparse.csr_array(S)


def test_shootout_record(shootout):
    labels = [c["label"] for c in shootout["configs"]]
    assert labels == ["uniform_2048_0.005", "uniform_2048_0.02",
                      "uniform_1024_0.08", "powerlaw_2e11_w8",
                      "clustered_fem_8x8", "hyper_sparse_2e11_W11"]
    assert shootout["platform"] == "cpu"
    assert shootout["platform_fp"] == "cpu:cpu:1"
    assert shootout["verdicts"] == len({c["verdict_key"]
                                        for c in shootout["configs"]})
    for cfg in shootout["configs"]:
        assert cfg["winner_loop_ms"] > 0 and cfg["bsr_ms"] > 0
        assert cfg["bsr_launches"] == 0        # the plain version, here
        assert 0 < cfg["bsr_bound_ms"] < cfg["bsr_ms"]
        assert cfg["verdict"] in tautotune.CANDIDATES


def test_shootout_equals_jax(shootout):
    """The same matrices and x as the JAX tool's, replayed from
    ``configs`` with the JAX tool's draws; the descriptors equal, and
    every raced candidate's product within f32 rounding."""
    from legate_sparse_tpu_torch.types import to_numpy_dtype

    import jax.numpy as jnp

    runtime.set_device("cpu")
    rng = np.random.default_rng(0)
    recs = iter(shootout["configs"])
    for label, spec in tune_irregular.configs(tune_irregular.SMOKE, rng):
        cfg = next(recs)
        J = _jax_config(spec)
        T = tune_irregular.build(spec, "cpu")
        T.sum_duplicates()
        x = rng.standard_normal(J.shape[1]).astype(J.dtype)
        assert to_numpy_dtype(T.dtype) == J.dtype == np.float32
        assert (cfg["label"], cfg["rows"], cfg["nnz"]) == (
            label, J.shape[0], J.nnz)
        assert cfg["density"] == round(J.nnz / (J.shape[0] * J.shape[1]), 6)
        assert cfg["fingerprint"] == J._get_fingerprint().klass
        jkey = jautotune.key_for(J, "spmv").key_id
        assert cfg["verdict_key"].split("@")[0] == jkey.split("@")[0]
        assert cfg["verdict_key"].split("/")[-1] == jkey.split("/")[-1]
        pack = jbsr.bsr_pack(np.asarray(J.data), np.asarray(J.indices),
                             np.asarray(J.indptr), J.shape, max_expand=1e9)
        assert cfg["nblocks"] == pack[0].shape[0]
        assert cfg["nnz_per_block"] == round(J.nnz / pack[0].shape[0], 1)
        want = np.asarray(J @ jnp.asarray(x))
        scale = max(float(np.abs(want).max()), 1.0)
        xt = torch.as_tensor(x)
        raced = [lbl for lbl in tautotune.CANDIDATES
                 if lbl.replace("-", "_") + "_ms" in cfg]
        assert "csr-rowids" in raced and cfg["verdict"] in raced
        for lbl in raced:
            y = tautotune.CANDIDATES[lbl].run(T, xt, "spmv").numpy()
            assert np.abs(y - want).max() <= 1e-5 * scale, (label, lbl)


def test_shootout_out_file(tmp_path, monkeypatch):
    """``--out`` writes the printed line; the run is the smoke's."""
    small = dict(tune_irregular.SMOKE, uniform=((256, 0.05),),
                 powerlaw_rows=256, clustered_rows=256, hyper_rows=256)
    monkeypatch.setattr(tune_irregular, "SMOKE", small)
    path = tmp_path / "shootout.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tune_irregular.main(["--smoke", "--device", "cpu", "--out",
                                   str(path)])
    assert path.read_text() == out.getvalue()
    assert json.loads(path.read_text()) == res
    assert [c["rows"] for c in res["configs"]] == [256] * 4
