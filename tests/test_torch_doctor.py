# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's doctor (``legate_sparse_tpu_torch/obs/doctor.py``, run as
``python -m legate_sparse_tpu_torch.obs.doctor``) against the repo's
``tools/doctor.py``: the doctor cases of ``tests/test_obs_v4.py`` and
``tests/test_delta.py::test_doctor_compaction_lagging_and_delta_disabled_rules``,
one for one.

Tolerance: exact.  Every case gives both doctors the same artifact or
the same evidence and holds the findings (severity, code, message, hint,
value, in order) and the exit codes equal; the artifacts are the
committed golden smoke result, the JAX tests' synthetic ones, and
Chrome traces and OpenMetrics snapshots written by the port.
"""

import json
import os
import subprocess
import sys

import pytest

from utils_test.tools import load_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "evidence", "BENCH_golden_smoke.json")


@pytest.fixture(scope="module")
def doctors():
    from legate_sparse_tpu_torch.obs import doctor

    return doctor, load_tool("doctor")


@pytest.fixture(autouse=True)
def _obs_isolation():
    from legate_sparse_tpu_torch import obs

    obs.reset_all()
    obs.disable()
    yield
    obs.reset_all()
    obs.disable()


def _same_findings(doctors, *paths):
    """Both doctors over ``paths``: equal detected kinds and findings."""
    port, jax_tool = doctors
    out = []
    for d in (port, jax_tool):
        ev = d.Evidence()
        kinds = [d.load_artifact(p, ev) for p in paths]
        out.append((kinds, d.diagnose(ev)))
    assert out[0] == out[1]
    return out[0]


def _same_main(doctors, argv, capsys):
    port, jax_tool = doctors
    rc = port.main(list(argv))
    text = capsys.readouterr().out
    assert jax_tool.main(list(argv)) == rc
    assert capsys.readouterr().out == text
    return rc, text


def _same_on_evidence(doctors, counters=None, bench=None, records=None):
    port, jax_tool = doctors
    out = []
    for d in (port, jax_tool):
        ev = d.Evidence()
        ev.counters = dict(counters or {})
        ev.bench.update(bench or {})
        ev.records = list(records or [])
        out.append(d.diagnose(ev))
    assert out[0] == out[1]
    return out[0]


def test_doctor_golden_smoke_findings_deterministic(doctors, capsys):
    """``test_obs_v4.py::test_doctor_golden_smoke_findings_deterministic``."""
    kinds, findings = _same_findings(doctors, GOLDEN)
    assert kinds == ["bench"]
    assert [f["code"] for f in findings] == ["breaker-trips",
                                             "gateway-rejections"]
    assert _same_main(doctors, ["--check", GOLDEN], capsys)[0] == 0
    assert _same_main(doctors, ["--check", "--fail-on", "warn", GOLDEN],
                      capsys)[0] == 1
    assert _same_main(doctors, ["--json", GOLDEN], capsys)[0] == 0


def test_doctor_flags_slo_breach_as_critical(doctors, tmp_path, capsys):
    """``::test_doctor_flags_slo_breach_as_critical``: on an OpenMetrics
    snapshot written by the port."""
    from legate_sparse_tpu_torch import obs

    obs.counters.inc("slo.breach.gateway.interactive", 3)
    prom = tmp_path / "m.prom"
    obs.export.write_openmetrics(str(prom))
    kinds, findings = _same_findings(doctors, str(prom))
    assert kinds == ["openmetrics"]
    assert (findings[0]["code"], findings[0]["severity"]) == \
        ("slo-breach", "critical")
    assert _same_main(doctors, ["--check", str(prom)], capsys)[0] == 1


def test_doctor_reads_trace_artifacts_and_ranks(doctors, tmp_path):
    """``::test_doctor_reads_trace_artifacts_and_ranks``: on a Chrome
    trace written by the port."""
    from legate_sparse_tpu_torch import obs

    obs.enable()
    obs.counters.inc("resil.breaker.trips", 2)
    obs.counters.inc("slo.breach.engine.request", 1)
    with obs.span("op.spmv"):
        pass
    path = str(tmp_path / "t.trace.json")
    obs.write_chrome_trace(path)
    kinds, findings = _same_findings(doctors, path)
    codes = [f["code"] for f in findings]
    assert kinds == ["trace"]
    assert codes[0] == "slo-breach" and "breaker-trips" in codes


def test_doctor_healthy_artifact_no_findings(doctors, tmp_path, capsys):
    """``::test_doctor_healthy_artifact_no_findings``."""
    p = tmp_path / "ok.json"
    p.write_text(json.dumps({"schema_version": 14, "metric": "x",
                             "value": 1.0, "engine_plan_hits": 9,
                             "engine_plan_misses": 1}))
    rc, out = _same_main(doctors, ["--check", "--fail-on", "info", str(p)],
                         capsys)
    assert rc == 0 and "no findings" in out


def test_doctor_unreadable_artifacts_exit_2(doctors, tmp_path, capsys):
    """``::test_doctor_unreadable_artifacts_exit_2``; and a planverify
    artifact, which the port does not read, counts as unreadable."""
    p = tmp_path / "junk.bin"
    p.write_text("not json, not openmetrics")
    assert _same_main(doctors, [str(p)], capsys)[0] == 2
    pv = tmp_path / "pv.json"
    pv.write_text(json.dumps({"tool": "planverify", "findings": []}))
    port, _ = doctors
    assert port.main([str(pv)]) == 2
    assert "planverify" in capsys.readouterr().err


def test_doctor_obs_overhead_and_roofline_rules(doctors):
    """``::test_doctor_obs_overhead_and_roofline_rules``."""
    findings = _same_on_evidence(doctors, bench={
        "obs_overhead_pct": 12.5, "cpu_roofline_ratio": 0.4,
        "cpu_roofline_items": {"mask_ms": 0.5, "pad_ms": 1.5}})
    codes = {f["code"]: f for f in findings}
    assert "obs-overhead" in codes
    roof = codes["roofline-shortfall"]["message"]
    assert roof.index("pad_ms") < roof.index("mask_ms")


def test_doctor_recovery_without_checkpoint_advance(doctors):
    """``::test_doctor_recovery_without_checkpoint_advance``."""
    f = {x["code"]: x for x in _same_on_evidence(
        doctors, bench={"resil_recoveries": 2, "resil_ckpt_saves": 0})}
    assert f["recovery-without-checkpoint-advance"]["severity"] == "warn"
    assert "CKPT_ITERS" in f["recovery-without-checkpoint-advance"]["hint"]
    assert "recovery-without-checkpoint-advance" not in {
        x["code"] for x in _same_on_evidence(
            doctors, bench={"resil_recoveries": 2, "resil_ckpt_saves": 4})}


def _verdict_rec(key, label):
    return {"type": "event", "name": "autotune.verdict", "ts_ns": 0,
            "tid": 0, "attrs": {"key": key, "label": label}}


def test_doctor_storage_wider_than_verdict(doctors):
    """``::test_doctor_storage_wider_than_verdict``."""
    port, jax_tool = doctors
    records = [
        _verdict_rec("spmv/bfloat16/banded/w8/r64/z256/k1/si16@cpu:cpu:8/e0",
                     "csr-rowids-bf16"),
        _verdict_rec("spmv/float32/banded/w8/r64/z256/k1@cpu:cpu:8/e0",
                     "csr-rowids"),
        _verdict_rec(
            "spmv/float32/powerlaw/w64/r262144/z2097152/k1@cpu:cpu:8/e0",
            "sliced-ell"),
        _verdict_rec("garbage", "x")]
    found = [f for f in _same_on_evidence(doctors, records=records)
             if f["code"] == "storage-wider-than-verdict"]
    assert len(found) == 1 and found[0]["severity"] == "warn"
    assert "banded/w8" in found[0]["message"]
    assert "compress()" in found[0]["hint"]
    for key in ("spmv/bfloat16/banded/w8/r64/z256/k1/si16@cpu:cpu:8/e0",
                "spmv/bfloat16/banded/w8/r64/z256/k1@tpu:v5p:64/e3",
                "garbage"):
        assert port._parse_verdict_key(key) == \
            jax_tool._parse_verdict_key(key)


def test_doctor_storage_rule_quiet_without_f32_twin(doctors):
    """``::test_doctor_storage_rule_quiet_without_f32_twin``."""
    assert not [f for f in _same_on_evidence(doctors, records=[
        _verdict_rec("spmv/bfloat16/banded/w8/r64/z256/k1/si16@cpu:cpu:8/e0",
                     "csr-rowids-bf16")])
        if f["code"] == "storage-wider-than-verdict"]


def test_doctor_compaction_lagging_and_delta_disabled_rules(doctors):
    """``test_delta.py::test_doctor_compaction_lagging_and_delta_disabled_rules``."""
    lag = next(f for f in _same_on_evidence(doctors, counters={
        "delta.watermark.exceeded": 3,
        "slo.breach.gateway.interactive": 2})
        if f["code"] == "compaction-lagging")
    assert (lag["severity"], lag["value"]) == ("warn", "3")
    assert "WORKER_MS" in lag["hint"]
    assert "compaction-lagging" not in [f["code"] for f in _same_on_evidence(
        doctors, counters={"delta.watermark.exceeded": 3})]
    ctrs = {"build.csr.coo.64x64": 5, "build.csr.coo.8x8": 1}
    reb = next(f for f in _same_on_evidence(doctors, counters=ctrs)
               if f["code"] == "delta-disabled-but-rebuilding")
    assert (reb["severity"], reb["value"]) == ("info", "5")
    assert "64x64" in reb["message"]
    for quiet in (dict(ctrs, **{"delta.updates": 1}),
                  {"build.csr.coo.64x64": 2}):
        assert "delta-disabled-but-rebuilding" not in [
            f["code"] for f in _same_on_evidence(doctors, counters=quiet)]


def test_doctor_module_cli_runs_without_jax(tmp_path):
    """``python -m legate_sparse_tpu_torch.obs.doctor`` in a fresh
    process: reads the port's trace and OpenMetrics artifacts, exits with
    the ``--check`` verdict, and imports no JAX."""
    from legate_sparse_tpu_torch import obs

    obs.enable()
    obs.counters.inc("slo.breach.gateway.interactive", 1)
    with obs.span("gateway.batch"):
        pass
    trace = str(tmp_path / "run.trace.json")
    prom = str(tmp_path / "run.prom")
    obs.write_chrome_trace(trace)
    obs.export.write_openmetrics(prom)
    code = ("import runpy, sys; sys.argv = ['doctor', '--check', "
            f"{trace!r}, {prom!r}]\n"
            "try:\n"
            "    runpy.run_module('legate_sparse_tpu_torch.obs.doctor', "
            "run_name='__main__')\n"
            "except SystemExit:\n"
            "    print('jax imported:', 'jax' in sys.modules)\n"
            "    raise\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(tmp_path))
    assert res.returncode == 1, res.stderr
    assert "slo-breach" in res.stdout
    assert "jax imported: False" in res.stdout
    assert "(trace)" in res.stderr and "(openmetrics)" in res.stderr
