# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's autotuner (``legate_sparse_tpu_torch/autotune``:
fingerprints, the candidate registry, the verdict store, routing, the
engine's defer) against the JAX package's on the CPU.

Mirrors ``tests/test_autotune.py`` and the autotune cases of
``tests/test_compressed_storage.py``.  The same scipy matrices, made
from a seed, go to both packages; the port runs on ``device="cpu"``.

Tolerances.  The fingerprint's class label equals the JAX package's on
every structure drawn here; its host moments (from ``indptr``, in f64)
are equal, and its two f32 device means (``spread``, ``block_score``,
summed in another order than XLA's) agree to 1e-6 relative.  A routed
product is bit for bit the direct call of the verdict's candidate, and
in f64 bit for bit the JAX package's candidate, save the sliced-ELL
ones at 1e-12 (XLA sums a wide bin's rows in another order).
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse
from legate_sparse_tpu import autotune as jautotune
from legate_sparse_tpu import gallery as jgallery
from legate_sparse_tpu import obs as jobs
from legate_sparse_tpu.settings import settings as jsettings

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import autotune, runtime
from legate_sparse_tpu_torch import obs as tobs
from legate_sparse_tpu_torch.autotune import (
    CANDIDATES, VerdictKey, VerdictStore, compute_fingerprint, key_for,
    platform_fingerprint,
)
from legate_sparse_tpu_torch.engine import core as engine_core
from legate_sparse_tpu_torch.ops import spmv as tspmv
from legate_sparse_tpu_torch.settings import settings as tsettings

_KNOBS = ("autotune", "autotune_store_size", "autotune_trials",
          "autotune_warmup", "engine")


@pytest.fixture(autouse=True)
def _isolation():
    runtime.set_device("cpu")
    saved = [{k: getattr(s, k) for k in _KNOBS}
             for s in (jsettings, tsettings)]
    autotune.reset()
    jautotune.reset()
    tobs.reset_all()
    jobs.reset_all()
    yield
    for s, vals in zip((jsettings, tsettings), saved):
        for k, v in vals.items():
            setattr(s, k, v)
    autotune.reset()
    jautotune.reset()
    engine_core.reset_engine()
    tobs.reset_all()
    jobs.reset_all()
    runtime.set_device(None)


def banded(n=512):
    return sp.diags([np.ones(n - 1), np.full(n, 4.0), np.ones(n - 1)],
                    [-1, 0, 1], format="csr", dtype=np.float32)


def uniform(n=512, density=0.02, seed=0, dtype=np.float32):
    return sp.random(n, n, density=density, format="csr",
                     random_state=np.random.default_rng(seed),
                     dtype=np.float64).astype(dtype)


_SCIPY_CACHE = {}


def powerlaw(n=512, nnz_per_row=4, seed=3, dtype=np.float32):
    key = ("pl", n, nnz_per_row, seed, np.dtype(dtype).name)
    if key not in _SCIPY_CACHE:
        A = jgallery.powerlaw(n, nnz_per_row=nnz_per_row, rng=seed,
                              dtype=dtype)
        A.sum_duplicates()
        _SCIPY_CACHE[key] = A.toscipy().tocsr()
    return _SCIPY_CACHE[key]


def rmat(scale=9, seed=5):
    key = ("rmat", scale, seed)
    if key not in _SCIPY_CACHE:
        G = jgallery.rmat(scale, nnz_per_row=8, rng=seed)
        G.sum_duplicates()
        _SCIPY_CACHE[key] = G.toscipy().tocsr().astype(np.float64)
    return _SCIPY_CACHE[key]


def blocks(n=512, seed=2):
    """Dense 8x8 blocks on a random block pattern: blocky structure."""
    rng = np.random.default_rng(seed)
    B = sp.random(n // 8, n // 8, density=0.05, random_state=rng,
                  format="csr")
    return sp.kron(B, np.ones((8, 8)), format="csr").astype(np.float32)


STRUCTURES = {"banded": banded, "uniform": uniform, "powerlaw": powerlaw,
              "rmat": rmat, "blocks": blocks}


def T(S):
    return tsparse.csr_array(S, device="cpu")


def same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.array_equal(a, b, equal_nan=True)


def counts(obs, prefix):
    return obs.counters.snapshot(prefix)


# ------------------------------------------------------------ fingerprints


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_fingerprint_class_equals_jax(name):
    S = STRUCTURES[name]()
    ft = compute_fingerprint(T(S))
    fj = jautotune.compute_fingerprint(jsparse.csr_array(S))
    assert ft.klass == fj.klass, (name, ft, fj)
    assert (ft.rows, ft.cols, ft.nnz, ft.width_bucket) == (
        fj.rows, fj.cols, fj.nnz, fj.width_bucket)
    for f in ("row_mean", "row_cv", "row_max_ratio"):
        assert getattr(ft, f) == getattr(fj, f), f
    for f in ("spread", "block_score"):
        np.testing.assert_allclose(getattr(ft, f), getattr(fj, f),
                                   rtol=1e-6, atol=1e-6)


def test_fingerprint_classes_separate_structures():
    kinds = {name: compute_fingerprint(T(make())).klass.split("/")[0]
             for name, make in STRUCTURES.items()}
    assert kinds["banded"] == "banded" and kinds["blocks"] == "blocky"
    assert kinds["uniform"] in ("uniform", "skewed")
    assert kinds["powerlaw"] in ("powerlaw", "skewed")


def test_fingerprint_empty_matrix():
    A = T(sp.csr_matrix((8, 8), dtype=np.float32))
    assert compute_fingerprint(A).klass == "empty/w1"


def test_fingerprint_cached_shared_and_invalidated():
    A = T(powerlaw())
    fp = A._get_fingerprint()
    assert fp is A._get_fingerprint()
    B = A._with_data(A.data * 2.0)           # same structure
    assert B._get_fingerprint() is fp
    A.data = A.data * 3.0                    # values only: kept
    assert A._fingerprint is fp
    A.sort_indices()
    A._invalidate_caches(structure_changed=True)
    assert A._fingerprint is None
    assert A._get_fingerprint() == fp        # rebuilt, same structure


def test_fingerprint_invariant_under_row_permutation():
    S = powerlaw()
    perm = np.random.default_rng(1).permutation(S.shape[0])
    fa, fb = compute_fingerprint(T(S)), compute_fingerprint(T(S[perm]))
    assert fa.row_cv == pytest.approx(fb.row_cv, rel=1e-9)
    assert fa.klass == fb.klass


# ------------------------------------------------------------------ store


def _key(i, epoch=None):
    return VerdictKey(op="spmv", dtype="float32", fp_class="uniform/w8",
                      rows_b=1024 * (i + 1), nnz_b=8192, k_b=1,
                      platform=platform_fingerprint(),
                      epoch=tsettings.epoch if epoch is None else epoch)


def test_platform_fingerprint_on_cpu():
    assert platform_fingerprint() == "cpu:cpu:1"


def test_store_lru_eviction():
    store = VerdictStore(capacity=2)
    for i in range(3):
        store.record(_key(i), "csr-rowids")
    assert len(store) == 2
    assert store.lookup(_key(0)) is None
    assert store.lookup(_key(2)) is not None
    assert tobs.counters.get("autotune.verdict.evictions") == 1


def test_store_persistence_roundtrip_and_format(tmp_path):
    """A record rewrites the JSON file, and a new store loads it back;
    the file has the JAX package's layout (the same keys)."""
    path = str(tmp_path / "verdicts.json")
    store = VerdictStore(capacity=8, path=path)
    store.record(_key(0), "sliced-ell",
                 timings_ms={"sliced-ell": 0.5, "csr-rowids": 2.0},
                 trials=5)
    v = VerdictStore(capacity=8, path=path).lookup(_key(0))
    assert v is not None and v.label == "sliced-ell"
    assert v.timings_ms["csr-rowids"] == 2.0 and v.trials == 5
    jpath = str(tmp_path / "jax.json")
    jkey = jautotune.VerdictKey(**dict(vars(_key(0)),
                                       platform=jautotune
                                       .platform_fingerprint()))
    jautotune.VerdictStore(capacity=8, path=jpath).record(
        jkey, "sliced-ell", timings_ms={"sliced-ell": 0.5}, trials=5)
    doc, jdoc = json.load(open(path)), json.load(open(jpath))
    assert sorted(doc) == sorted(jdoc)
    assert sorted(doc["verdicts"][0]) == sorted(jdoc["verdicts"][0])


def test_store_load_drops_foreign_platform_and_epoch(tmp_path):
    path = str(tmp_path / "verdicts.json")
    VerdictStore(capacity=8, path=path).record(_key(0), "ell")
    doc = json.loads(open(path).read())
    doc["verdicts"][0]["platform"] = "cuda:NVIDIA H100 80GB HBM3:1"
    doc["verdicts"].append(dict(doc["verdicts"][0],
                                platform=platform_fingerprint(),
                                epoch=tsettings.epoch + 999))
    with open(path, "w") as f:
        json.dump(doc, f)
    assert len(VerdictStore(capacity=8, path=path)) == 0


def test_key_for_equals_jax_but_platform():
    S = uniform()
    kt = key_for(T(S), "spmv")
    kj = jautotune.key_for(jsparse.csr_array(S), "spmv")
    assert dict(vars(kt), platform="", epoch=0) == dict(
        vars(kj), platform="", epoch=0)
    assert kt.key_id.split("@")[0] == kj.key_id.split("@")[0]
    assert kt.epoch == tsettings.epoch
    C, Cj = T(S).compress(), jsparse.csr_array(S).compress()
    kc, kcj = key_for(C, "spmm", k=3), jautotune.key_for(Cj, "spmm", k=3)
    assert kc.key_id.split("@")[0] == kcj.key_id.split("@")[0]
    assert (kc.dtype, kc.storage, kc.k_b) == ("bfloat16", "i16", 4)
    saved = tsettings.ell_max_expand
    try:
        tsettings.ell_max_expand = saved + 1.0
        assert key_for(T(S), "spmv").epoch == kt.epoch + 1
    finally:
        tsettings.ell_max_expand = saved


# ---------------------------------------------------------------- routing


def test_autotune_off_is_inert():
    A = T(powerlaw())
    x = torch.ones(A.shape[1])
    y = A @ x
    assert counts(tobs, "autotune.") == {}
    tsettings.autotune = True                 # on, a miss: same result
    assert same(A @ x, y)
    assert tobs.counters.get("autotune.route.miss") == 1
    assert tobs.counters.get("autotune.route.hits") == 0


@pytest.mark.parametrize("label", ["csr-rowids", "sliced-ell",
                                   "semiring-csr", "semiring-sliced-ell"])
def test_routed_spmv_bitwise_direct_and_jax(label):
    S = powerlaw(dtype=np.float64)
    A, J = T(S), jsparse.csr_array(S)
    x = np.random.default_rng(0).standard_normal(S.shape[1])
    tsettings.autotune = True
    autotune.get_store().record(key_for(A, "spmv"), label)
    y = A @ x
    assert A.spmv_path == label
    assert tobs.counters.get("autotune.route.hits") == 1
    assert tobs.counters.get("autotune.route." + label) == 1
    assert same(y, CANDIDATES[label].run(A, torch.as_tensor(x), "spmv"))
    yj = np.asarray(jautotune.CANDIDATES[label].run(J, x, "spmv"))
    if "sliced" in label:
        # XLA sums a wide bin's rows in another order than slot order
        # (test_torch_compressed.py::test_sliced_ell_pack_and_spmv_bitwise).
        np.testing.assert_allclose(y.numpy(), yj, rtol=1e-12, atol=1e-12)
    else:
        assert same(y, yj)


def test_routed_spmm_bitwise_direct():
    A = T(uniform())
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (512, 4)).astype(np.float32))
    tsettings.autotune = True
    autotune.get_store().record(key_for(A, "spmm", k=4), "csr-rowids")
    Y = A @ X
    assert A.spmm_path == "csr-rowids"
    assert same(Y, CANDIDATES["csr-rowids"].run(A, X, "spmm"))


@pytest.mark.parametrize("label", ["csr-rowids-bf16", "ell-bf16"])
def test_routed_bf16_verdict_bitwise_direct(label):
    C = T(uniform(256, density=0.05, seed=9)).compress()
    x = torch.linspace(-1.0, 1.0, 256)
    tsettings.autotune = True
    autotune.get_store().record(key_for(C, "spmv"), label)
    y = C @ x
    assert tobs.counters.get("autotune.route." + label) == 1
    assert y.dtype == torch.float32
    assert same(y, CANDIDATES[label].run(C, x, "spmv"))


def test_widening_declines_non_bf16_verdict():
    C = T(uniform(256, density=0.05, seed=10)).compress()
    tsettings.autotune = True
    autotune.get_store().record(key_for(C, "spmv"), "csr-rowids")
    y = C @ torch.linspace(-1.0, 1.0, 256)
    assert tobs.counters.get("autotune.route.decline") == 1
    assert y.dtype == torch.float32 and C.spmv_path == "ell-bf16"


def test_route_declines():
    """Promotion, a banded matrix and a stale verdict decline into the
    heuristic chain, counted, never erroring."""
    tsettings.autotune = True
    A = T(powerlaw())
    autotune.get_store().record(key_for(A, "spmv"), "sliced-ell")
    assert autotune.route_matvec(A, torch.ones(512, dtype=torch.float64)) \
        is None
    Bd = T(banded())
    autotune.get_store().record(key_for(Bd, "spmv"), "csr-rowids")
    assert autotune.route_matvec(Bd, torch.ones(512)) is None
    A._sliced_ell = False
    y = A @ torch.ones(512)
    assert tuple(y.shape) == (512,)
    assert tobs.counters.get("autotune.route.decline") == 3
    assert tobs.counters.get("autotune.route.hits") == 0


def test_engine_defers_to_non_csr_verdict():
    tsettings.autotune = True
    tsettings.engine = True
    A = T(powerlaw())
    x = torch.ones(512)
    autotune.get_store().record(key_for(A, "spmv"), "sliced-ell")
    y = A @ x
    assert tobs.counters.get("autotune.engine.defer") == 1
    assert tobs.counters.get("autotune.route.hits") == 1
    assert A.spmv_path == "sliced-ell"
    assert same(y, tspmv.sliced_ell_spmv(A._get_sliced_ell(), x, 512))


def test_engine_keeps_csr_rowids_verdict():
    tsettings.autotune = True
    tsettings.engine = True
    A = T(uniform())
    autotune.get_store().record(key_for(A, "spmv"), "csr-rowids")
    _ = A @ torch.ones(512)
    assert tobs.counters.get("autotune.engine.defer") == 0
    assert A.spmv_path == "engine"


def test_route_counts_equal_jax():
    """The same verdicts and dispatches move the same ``autotune.*``
    counters in both packages."""
    S = powerlaw()
    for pkg, make, st in ((autotune, T, tsettings),
                          (jautotune, jsparse.csr_array, jsettings)):
        st.autotune = True
        A = make(S)
        pkg.get_store().record(pkg.key_for(A, "spmv"), "sliced-ell")
        for _ in range(2):
            A @ np.ones(512, np.float32)
        A @ np.ones((512, 2), np.float32)              # spmm: a miss
        st.autotune = False
    assert counts(tobs, "autotune.") == counts(jobs, "autotune.")


# --------------------------------------------------------- registry / tune


def test_registry_equals_jax():
    assert sorted(CANDIDATES) == sorted(jautotune.CANDIDATES)
    for label, c in CANDIDATES.items():
        j = jautotune.CANDIDATES[label]
        assert (c.label, c.kernel, c.ops) == (j.label, j.kernel, j.ops)
        assert hasattr(tspmv, c.kernel), c.kernel
    assert not CANDIDATES["coo-segment"].eligible(T(uniform()))


@pytest.mark.parametrize("name", ["uniform", "powerlaw"])
def test_eligible_candidates_equal_jax(name):
    S = STRUCTURES[name]()
    for op in ("spmv", "spmm"):
        assert sorted(autotune.eligible_candidates(T(S), op)) == sorted(
            jautotune.eligible_candidates(jsparse.csr_array(S), op))


def test_measure_and_tune_records_winner_and_routes():
    tsettings.autotune = True
    A = T(powerlaw())
    x = torch.ones(512)
    timings = autotune.measure_candidates(A, warmup=0, trials=1)
    assert set(timings) == set(autotune.eligible_candidates(A, "spmv"))
    assert all(ms > 0 for ms in timings.values())
    verdict = autotune.tune(A, x, warmup=0, trials=3)
    assert verdict.label in verdict.timings_ms and verdict.trials == 3
    assert autotune.get_store().lookup(key_for(A, "spmv")) is verdict
    assert tobs.counters.get("autotune.measure.trials") == (
        len(timings) + 3 * len(verdict.timings_ms))
    y = A @ x
    assert A.spmv_path == verdict.label
    assert same(y, CANDIDATES[verdict.label].run(A, x, "spmv"))
