# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's spans inside the CG loop, the V-cycle and the hierarchy
build, and ``obs.timeline``: the spans joined to a ``torch.profiler``
trace (device time and idle gaps by span).

The CPU cases hold the new sites to what they count (``cg.iter`` spans
to the iterations ``cg`` returns, ``cg.fetch`` to the
``transfer.host_sync.cg_conv`` counter, ``gmg.level`` nesting, the
``gmg.build.*`` laps to ``GMG.build_s``), the sites to nothing with
tracing off, the join and its reductions to synthetic profiler events,
and every name the port emits to ``docs/OBSERVABILITY.md`` or the
port's own ``legate_sparse_tpu_torch/obs/OBSERVABILITY.md``.  The case
marked ``gpu`` joins a real trace on the card and skips without one.
This file imports neither ``jax`` nor the JAX package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_obs_timeline.py
"""

import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from legate_sparse_tpu_torch import linalg, obs, runtime
from legate_sparse_tpu_torch.apps import gmg
from legate_sparse_tpu_torch.apps.common import poisson2D
from legate_sparse_tpu_torch.obs import counters, timeline, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolation():
    """Each test starts with tracing off and empty buffers, on the
    CPU, and leaves nothing behind."""
    runtime.set_device("cpu")
    obs.reset_all()
    trace.disable()
    yield
    trace.disable()
    obs.reset_all()


def _spans(name):
    return [r for r in obs.records() if r["name"] == name]


def _inside(inner, outer):
    return (outer["ts_ns"] <= inner["ts_ns"] and inner["ts_ns"]
            + inner["dur_ns"] <= outer["ts_ns"] + outer["dur_ns"])


# ---------------------------------------------------------------- #
# the sites
# ---------------------------------------------------------------- #

@pytest.mark.parametrize("maxiter,conv", [(500, 25), (500, 7), (30, 25)])
def test_cg_iter_and_fetch_spans_count_iterations_and_syncs(maxiter, conv):
    A = poisson2D(12, dtype=torch.float64)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    trace.enable()
    before = counters.get("transfer.host_sync.cg_conv")
    _, iters = linalg.cg(A, b, rtol=1e-10, maxiter=maxiter,
                         conv_test_iters=conv)
    fetches = counters.get("transfer.host_sync.cg_conv") - before
    assert iters > 0 and len(_spans("cg.iter")) == iters
    assert fetches > 0 and len(_spans("cg.fetch")) == fetches
    (solve,) = _spans("cg")
    assert all(_inside(r, solve) for r in _spans("cg.iter"))
    assert all(any(_inside(f, it) for it in _spans("cg.iter"))
               for f in _spans("cg.fetch"))


def _hierarchy(levels=3, n=16):
    A = poisson2D(n, dtype=torch.float64)
    return A, gmg.GMG(A, (n, n), levels, "jacobi", "linear")


@pytest.mark.parametrize("levels", [2, 3, 4])
def test_gmg_cycle_holds_one_nested_level_span_per_level(levels):
    A, mg = _hierarchy(levels)
    r = torch.rand(A.shape[0], dtype=torch.float64)
    trace.enable()
    mg.cycle(r)
    mg.cycle(r)
    cycles = _spans("gmg.cycle")
    assert len(cycles) == 2
    for cyc in cycles:
        inner = sorted((s for s in _spans("gmg.level") if _inside(s, cyc)),
                       key=lambda s: s["attrs"]["level"])
        assert [s["attrs"]["level"] for s in inner] == list(range(levels))
        assert inner[0]["attrs"]["rows"] == A.shape[0]
        for outer, deeper in zip(inner, inner[1:]):
            assert _inside(deeper, outer)
            assert deeper["attrs"]["rows"] < outer["attrs"]["rows"]


def test_gmg_build_spans_sum_to_build_s():
    trace.enable()
    _, mg = _hierarchy(3)
    for part in ("restriction", "galerkin", "smoother"):
        spans = _spans("gmg.build." + part)
        assert spans
        assert sum(s["dur_ns"] for s in spans) * 1e-9 == pytest.approx(
            mg.build_s[part], rel=1e-12, abs=1e-15)
    assert sorted(s["attrs"]["level"]
                  for s in _spans("gmg.build.smoother")) == [0, 1, 2, 3]
    assert sorted(s["attrs"]["level"]
                  for s in _spans("gmg.build.restriction")) == [0, 1, 2]


def test_sites_record_nothing_with_tracing_off():
    A, mg = _hierarchy(3)
    mg.cycle(torch.rand(A.shape[0], dtype=torch.float64))
    linalg.cg(A, torch.ones(A.shape[0], dtype=torch.float64), rtol=1e-8,
              M=mg.linear_operator())
    assert obs.records() == []
    assert set(mg.build_s) == {"restriction", "galerkin", "smoother"}
    assert counters.get("transfer.host_sync.cg_conv") > 0


def test_span_stop_ends_the_interval():
    trace.enable()
    with obs.span("probe") as sp:
        sp.stop()
        time.sleep(0.05)
    (rec,) = _spans("probe")
    assert rec["dur_ns"] < 0.05e9


PRICE_S = 0.2      # a pricing slower than any product here


def test_spmv_span_ends_before_its_pricing(monkeypatch):
    A = poisson2D(8, dtype=torch.float64)
    priced = []
    real = type(A).spmv_traffic_bytes

    def slow(self, x, path=None):
        time.sleep(PRICE_S)
        priced.append(path)
        return real(self, x, path)

    x = torch.ones(A.shape[0], dtype=torch.float64)
    A @ x                   # the first product builds the band
    monkeypatch.setattr(type(A), "spmv_traffic_bytes", slow)
    trace.enable()
    A @ x
    assert len(priced) == 1 and _spans("spmv")[0]["dur_ns"] < PRICE_S * 1e9
    assert _spans("spmv")[0]["attrs"]["bytes"] > 0
    linalg.cg(A, x, rtol=0.0, maxiter=3)
    # The solve's products price their spans inside the solve's; its
    # own pricing, after them, lies outside.
    inner = len(_spans("spmv")) - 1
    (solve,) = _spans("cg")
    assert len(priced) == inner + 2
    assert solve["dur_ns"] < PRICE_S * 1e9 * (inner + 1)
    assert solve["attrs"]["bytes"] > 0


# ---------------------------------------------------------------- #
# the join, on synthetic profiler events
# ---------------------------------------------------------------- #

OFFSET_US = 1000.0     # the records' microseconds less the profiler's


def _rec(name, start_us, end_us, **attrs):
    """A span record whose interval, on the profiler's clock, is
    [start_us, end_us]."""
    rec = {"type": "span", "name": name,
           "ts_ns": int(round((start_us + OFFSET_US) * 1e3)),
           "dur_ns": int(round((end_us - start_us) * 1e3))}
    if attrs:
        rec["attrs"] = attrs
    return rec


def _ev(name, s, e, corr, device):
    return timeline.Event(name, float(s), float(e), corr, device)


def _synthetic():
    """Two anchors; a cg.iter holding an spmv (one kernel), a vector
    op and a fetch; a gmg.cycle with levels 0 and 1; a gap in no span."""
    records = [
        _rec("obs.anchor", 0, 10, at="open"),
        _rec("cg.iter", 20, 100),
        _rec("spmv", 22, 30),
        _rec("cg.fetch", 60, 95),
        _rec("gmg.cycle", 120, 200),
        _rec("gmg.level", 121, 199, level=0, rows=64),
        _rec("gmg.level", 140, 170, level=1, rows=16),
        _rec("obs.anchor", 300, 310, at="close"),
    ]
    events = [
        _ev("cudaDeviceSynchronize", 3, 7, 1, False),
        _ev("cudaLaunchKernel", 24, 26, 2, False),     # inside spmv
        _ev("dia_spmv", 27, 47, 2, True),
        _ev("cudaLaunchKernel", 40, 42, 3, False),     # cg.iter alone
        _ev("axpy", 47, 52, 3, True),
        _ev("cudaMemcpyAsync", 61, 90, 4, False),      # the fetch
        _ev("Memcpy DtoH", 80, 81, 4, True),           # gap 52-80 in fetch
        _ev("cudaLaunchKernel", 125, 126, 5, False),   # level 0
        _ev("smooth", 130, 140, 5, True),
        _ev("cudaLaunchKernel", 145, 146, 6, False),   # level 1
        _ev("coarse", 150, 154, 6, True),
        _ev("cudaLaunchKernel", 172, 173, 7, False),   # level 0 again
        _ev("prolong", 175, 185, 7, True),
        _ev("cudaLaunchKernel", 250, 251, 8, False),   # no span
        _ev("tail", 260, 262, 8, True),                # gap 185-260
        _ev("cudaDeviceSynchronize", 302, 309, 9, False),
    ]
    return records, events


def test_join_reads_the_offset_from_the_anchors():
    records, events = _synthetic()
    tl = timeline.join(records, events)
    assert tl.offset_us == pytest.approx(OFFSET_US, abs=1e-6)
    assert tl.offset_bound_us == pytest.approx(3.0)
    assert tl.skew_us == pytest.approx(-0.5, abs=1e-6)
    (it,) = [s for s in tl.spans if s.name == "cg.iter"]
    assert (it.start_us, it.end_us) == pytest.approx((20.0, 100.0))
    with pytest.raises(ValueError, match="anchor"):
        timeline.join(records[1:-1], events)


def test_join_attributes_kernels_by_their_launch_and_gaps_by_midpoint():
    records, events = _synthetic()
    tl = timeline.join(records, events)
    inner = {name: tl._innermost(stack) for name, _, _, stack in tl.ops}
    # dia_spmv starts after the spmv span closed: its launch decides.
    assert inner == {"dia_spmv": "spmv", "axpy": "cg.iter",
                     "Memcpy DtoH": "cg.fetch", "smooth": "gmg.level@0",
                     "coarse": "gmg.level@1", "prolong": "gmg.level@0",
                     "tail": "no span"}
    assert [(s, e) for _, s, e, _ in tl.gaps] == [
        (52.0, 80.0), (81.0, 130.0), (140.0, 150.0), (154.0, 175.0),
        (185.0, 260.0)]
    idle = dict(tl.idle_by_span())
    assert idle == pytest.approx({
        "cg.fetch": 28e-6, "no span": 124e-6, "gmg.level@1": 31e-6})
    assert tl.idle_by_span(top=1) == [["no span", pytest.approx(124e-6)]]
    dev = dict(tl.device_by_span())
    assert dev == pytest.approx({
        "spmv": 20e-6, "cg.iter": 5e-6, "cg.fetch": 1e-6,
        "gmg.level@0": 20e-6, "gmg.level@1": 4e-6, "no span": 2e-6})


def test_timeline_reductions_for_the_layer_metrics():
    records, events = _synthetic()
    tl = timeline.join(records, events)
    # The CG loop's own operations: in cg.iter, outside spmv and the
    # preconditioner.
    assert tl.device_seconds("cg.iter", ("spmv", "gmg.cycle")) == \
        pytest.approx(6e-6)
    assert tl.device_seconds("cg.iter") == pytest.approx(26e-6)
    assert tl.device_seconds_by("gmg.level", "level") == pytest.approx(
        {0: 20e-6, 1: 4e-6})
    assert tl.count("cg.iter") == 1 and tl.count("gmg.level") == 2
    assert tl.count("obs.anchor") == 2
    assert tl.skew_us is not None
    assert tl.span_seconds("gmg.level") == pytest.approx(108e-6)
    # spmv's 8 us less its launch (2 us); cg.fetch's 35 us less its copy
    # (29 us).
    assert tl.host_seconds("spmv") == pytest.approx(6e-6)
    assert tl.host_seconds("cg.fetch") == pytest.approx(6e-6)
    assert [c[0] for c in tl.calls if not c[3]] == ["cudaLaunchKernel"]
    assert [tl._innermost(c[3]) for c in tl.calls][:4] == [
        "obs.anchor", "spmv", "cg.iter", "cg.fetch"]


def test_busy_seconds_and_lost_launches():
    records, events = _synthetic()
    tl = timeline.join(records, events)
    # The seven operations do not overlap: 52 us in all.
    assert tl.busy_s() == pytest.approx(52e-6)
    assert (tl.launches, tl.lost) == (6, 0)
    # A launch whose device record the profiler dropped.
    tl = timeline.join(records, events + [
        _ev("cudaLaunchKernel", 255, 256, 10, False)])
    assert (tl.launches, tl.lost) == (7, 1)
    assert tl.busy_s() == pytest.approx(52e-6)


def test_offset_comes_from_the_tightest_anchor():
    # The first opening anchor holds a 3 ms host stall after its call;
    # the second is tight.  The profiler syncs once more after the
    # closing anchor.
    records = [_rec("obs.anchor", 0, 3000, at="open"),
               _rec("obs.anchor", 3000, 3010, at="open"),
               _rec("k", 3020, 3030),
               _rec("obs.anchor", 3100, 3108, at="close")]
    events = [_ev("cudaDeviceSynchronize", 4, 8, 1, False),
              _ev("cudaDeviceSynchronize", 3003, 3008, 2, False),
              _ev("cudaDeviceSynchronize", 3102, 3107, 3, False),
              _ev("cudaDeviceSynchronize", 3150, 3151, 4, False)]
    tl = timeline.join(records, events)
    assert tl.offset_us == pytest.approx(OFFSET_US - 0.5)
    assert tl.offset_bound_us == pytest.approx(2.5)
    assert tl.skew_us == pytest.approx(0.0, abs=1e-9)


def test_join_nests_spans_that_share_an_instant():
    records = [_rec("obs.anchor", 0, 1, at="open"), _rec("outer", 10, 50),
               _rec("inner", 10, 20)]
    events = [_ev("cudaDeviceSynchronize", 0, 1, 1, False),
              _ev("cudaLaunchKernel", 10, 11, 2, False),
              _ev("k", 12, 13, 2, True),
              _ev("k2", 30, 31, 3, True)]      # no launch in the trace
    tl = timeline.join(records, events)
    stacks = {name: [tl.spans[i].name for i in st]
              for name, _, _, st in tl.ops}
    assert stacks == {"k": ["outer", "inner"], "k2": ["outer"]}


def test_from_profiler_keeps_device_ops_and_runtime_calls():
    from torch.autograd import DeviceType

    def fe(name, dev, s, e, i, annotation=False):
        return SimpleNamespace(
            name=name, device_type=dev, id=i, is_user_annotation=annotation,
            time_range=SimpleNamespace(start=s, end=e))

    evs = timeline.from_profiler([
        fe("cudaLaunchKernel", DeviceType.CPU, 1, 2, 7),
        fe("aten::add", DeviceType.CPU, 0, 3, 8),
        fe("region", DeviceType.CPU, 0, 9, 9, annotation=True),
        fe("void k<float>()", DeviceType.CUDA, 4, 6, 7),
    ])
    assert evs == [timeline.Event("cudaLaunchKernel", 1.0, 2.0, 7, False),
                   timeline.Event("void k<float>()", 4.0, 6.0, 7, True)]


def test_delta_keeps_what_moved():
    assert timeline.delta({"a": 3, "b": 1, "h": (5, 2.5)},
                          {"a": 1, "b": 1, "h": (2, 1.0)}) == {
        "a": 2, "h": (3, 1.5)}


def test_slice_off_the_card_runs_untraced():
    with timeline.Slice(torch.device("cpu")) as sl:
        with obs.span("probe"):
            pass
    assert sl.timeline is None and obs.records() == []


class _FakeProfile:
    """``torch.profiler.profile`` on the CPU: one synchronisation event
    inside each ``obs.anchor`` span recorded while it was open."""

    def __init__(self, activities):
        pass

    def __enter__(self):
        self._mark = trace.mark()
        return self

    def __exit__(self, *exc):
        self._records = trace.records(self._mark)
        return False

    def events(self):
        from torch.autograd import DeviceType

        return [SimpleNamespace(
            name="cudaDeviceSynchronize", device_type=DeviceType.CPU, id=k,
            is_user_annotation=False, time_range=SimpleNamespace(
                start=r["ts_ns"] * 1e-3,
                end=(r["ts_ns"] + r["dur_ns"]) * 1e-3))
            for k, r in enumerate(self._records) if r["name"] == "obs.anchor"]


@pytest.mark.parametrize("was_on", [True, False])
def test_slice_keeps_the_records_made_before_it(monkeypatch, was_on):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    trace.enable()
    with obs.span("probe"):
        pass
    if not was_on:
        trace.disable()
    with timeline.Slice(SimpleNamespace(type="cuda")) as sl:
        with obs.span("probe"):
            pass
    assert trace.enabled() is was_on
    probes = _spans("probe")
    # The earlier record stays, and the sequence numbers run on.
    assert [r["seq"] for r in probes] == [0, 1]
    assert [r["first"] for r in probes] == [True, False]
    # The timeline holds the slice's records alone.
    assert [s.name for s in sl.timeline.spans].count("probe") == 1
    assert sl.timeline.count("obs.anchor") == 2 * timeline.ANCHOR_REPEATS


def test_profile_device_off_the_card_reads_no_device_time():
    out = gmg.profile_device(lambda: torch.ones(4).sum(),
                             torch.device("cpu"))
    assert out["device_ms"] == 0.0 and out["top"] == []
    assert out["wall_ms"] >= 0.0


# ---------------------------------------------------------------- #
# docs
# ---------------------------------------------------------------- #

def test_port_obs_names_are_documented():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tools.lint.rules import obs_docs

    emissions = obs_docs.collect_emissions(
        os.path.join(REPO, "legate_sparse_tpu_torch"), REPO)
    docs = [os.path.join(REPO, "docs", "OBSERVABILITY.md"),
            os.path.join(REPO, "legate_sparse_tpu_torch", "obs",
                         "OBSERVABILITY.md")]
    text = "".join(open(path).read() for path in docs)
    exact, prefixes = obs_docs.doc_patterns(text)
    missing = sorted(name for name, is_prefix in emissions
                     if not obs_docs.documented(name, is_prefix, exact,
                                                prefixes))
    assert missing == []
    names = {name for name, _ in emissions}
    assert {"cg.iter", "cg.fetch", "gmg.cycle", "gmg.level",
            "gmg.build.", "obs.anchor"} <= names
    # The port's own names are on the port's page, not the JAX one's.
    port_exact, _ = obs_docs.doc_patterns(open(docs[1]).read())
    assert {"cg.fetch", "gmg.cycle", "gmg.level", "obs.anchor",
            "gmg.build.restriction"} <= port_exact


# ---------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler traces the card")
    runtime.set_device("cuda")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_holds_its_product_on_the_card(cuda):
    A = poisson2D(512, device=cuda, dtype=torch.float32)
    x = torch.rand(A.shape[0], device=cuda)
    A @ x
    with timeline.Slice(cuda):          # the profiler's one-off start-up
        A @ x
    with timeline.Slice(cuda) as sl:
        with obs.span("probe"):
            A @ x
            torch.cuda.synchronize(cuda)
    tl = sl.timeline
    # The first slice's records stay in the buffer; the second's
    # timeline holds its own alone.
    assert len([r for r in obs.records() if r["name"] == "obs.anchor"]) \
        == 4 * timeline.ANCHOR_REPEATS
    assert tl.count("obs.anchor") == 2 * timeline.ANCHOR_REPEATS
    assert tl.launches >= 1 and 0.0 < tl.busy_s() <= sl.wall_s
    (probe,) = [s for s in tl.spans if s.name == "probe"]
    (op,) = [op for op in tl.ops if "dia_spmv" in op[0]]
    name, start, end, stack = op
    assert [tl.spans[i].name for i in stack] == ["probe", "spmv",
                                                 "kernel.dia_spmv"]
    assert probe.start_us <= start and probe.end_us >= end - 20.0
    assert tl.offset_bound_us < 20.0 and abs(tl.skew_us) < 20.0
